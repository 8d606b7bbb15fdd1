"""The port's Generator and its train-mode building blocks against the JAX
package's, with the same weights: forward, BatchNorm running statistics,
the folded conv biases and the gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Generator as JaxGenerator
from fcdgan_tpu_torch.io.torch_interop import from_jax_variables
from fcdgan_tpu_torch.models import layers
from fcdgan_tpu_torch.models.generator import Generator

HW = 32


def _seeded(rng, path, v):
    """Non-trivial BN scales/biases and PReLU slopes; convs keep their init."""
    name, parent = path[-1].key, path[-2].key
    if name == "scale":
        return rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    if name == "bias" and "BatchNorm" in parent:
        return rng.normal(0.0, 0.2, size=v.shape).astype(np.float32)
    if name == "alpha":
        return rng.uniform(0.1, 0.4, size=v.shape).astype(np.float32)
    return np.asarray(v)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    model = JaxGenerator(3)
    x = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    vs = jax.jit(lambda a: model.init({"params": jax.random.PRNGKey(3)}, a))(jnp.asarray(x))
    params = jax.tree_util.tree_map_with_path(lambda p, v: _seeded(rng, p, v), vs["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 2.0, size=v.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.5, size=v.shape)).astype(np.float32),
        vs["batch_stats"])
    # a mean-scaled cotangent, as the losses' means give
    cot = (rng.normal(size=(2, HW, HW, 3)) / (2 * HW * HW * 3)).astype(np.float32)

    @jax.jit
    def train_fwd(p, a):
        def f(p_):
            y, muts = model.apply({"params": p_, "batch_stats": stats}, a, train=True,
                                  mutable=["batch_stats"])
            return jnp.vdot(y, cot), (y, muts["batch_stats"])
        (_, (y, new_stats)), grads = jax.value_and_grad(f, has_aux=True)(p)
        return y, new_stats, grads

    y, new_stats, grads = train_fwd(params, jnp.asarray(x))
    y_eval = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         train=False)
    variables = {"params": params, "batch_stats": stats}
    new_sd = variables_to_torch(params, new_stats, kind="generator")
    grad_sd = variables_to_torch(grads, stats, kind="generator")
    return dict(variables=variables, x=x, cot=cot, y=np.asarray(y),
                y_eval=np.asarray(y_eval), new_sd=new_sd, grad_sd=grad_sd)


def _net(case):
    net = Generator(3)
    net.load_state_dict(from_jax_variables(case["variables"], "generator"), strict=True)
    return net


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_state_dict_equals_jax_unit_map(case):
    ours = from_jax_variables(case["variables"], "generator")
    theirs = variables_to_torch(case["variables"]["params"],
                                case["variables"]["batch_stats"], kind="generator")
    assert list(ours) == list(theirs) and set(ours) == set(Generator(3).state_dict())
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])


def test_train_forward_stats_and_gradients_match_jax(case):
    net = _net(case).train()
    y = net(_nchw(case["x"]))
    # the JAX package's torch-golden bound (tests/test_torch_parity.py:203)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), case["y"],
                               atol=5e-4)
    sd = net.state_dict()
    for k, v in case["new_sd"].items():
        if k.endswith("running_mean") or k.endswith("running_var"):
            # the biased batch variance goes to the running buffer, as in JAX
            np.testing.assert_allclose(sd[k].numpy(), v, atol=1e-5, err_msg=k)
    (y * _nchw(case["cot"])).sum().backward()
    folded = {f"block{i}.conv{j}.bias" for i in range(2, 7) for j in (1, 2)}
    folded.add("block7.0.bias")
    for name, p in net.named_parameters():
        want = case["grad_sd"][name]
        if name in folded:  # bias folded into the BN: no gradient at all
            assert p.grad is None, name
            np.testing.assert_array_equal(want, 0.0)
            continue
        # the train-step gradient tolerance of tests/test_steps.py:180
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=2e-3, atol=2e-5,
                                   err_msg=name)


def test_eval_forward_matches_jax(case):
    net = _net(case).eval()
    with torch.no_grad():
        y = net(_nchw(case["x"]))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), case["y_eval"], atol=5e-4)


def test_trunk_convs_route_through_the_kernel(monkeypatch, case):
    """The eleven 64 -> 64 3x3 convs pass the gate; the 9x9s do not."""
    calls = []
    real = layers.conv3x3

    def spy(a, w):
        calls.append((tuple(a.shape), tuple(w.shape)))
        return real(a, w)

    monkeypatch.setattr(layers, "conv3x3", spy)
    net = _net(case).train()
    net(_nchw(case["x"])).sum().backward()
    assert calls == [((2, HW, HW, 64), (3, 3, 64, 64))] * 11


def test_bf16_train_forward_stays_close(case):
    net = _net(case).train()
    net.compute_dtype = torch.bfloat16
    y = net(_nchw(case["x"]))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    y.sum().backward()
    assert all(p.grad is None or torch.isfinite(p.grad).all() for p in net.parameters())
    # bf16 keeps 8 significand bits through 14 layers: a loose sanity bound
    assert np.abs(y.permute(0, 2, 3, 1).detach().numpy() - case["y"]).max() < 0.25
