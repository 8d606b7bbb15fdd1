"""The port's eval-mode Segmentor against the JAX package's, same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu_torch.io.torch_interop import from_jax_variables
from fcdgan_tpu_torch.models import layers
from fcdgan_tpu_torch.models.segmentor import Segmentor


def _bn_seeded(rng, path, v):
    """Seeded non-trivial BN scale/bias; conv kernels and biases keep init."""
    name = path[-1].key
    if name == "scale":
        return rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
    if name == "bias" and "BatchNorm" in path[-2].key:
        return rng.normal(0.0, 0.2, size=v.shape).astype(np.float32)
    return np.asarray(v)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    model = JaxSegmentor(3, bilinear=True)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    vs = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                    jnp.asarray(y), train=False)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: _bn_seeded(rng, p, v), vs["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 2.0, size=v.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.5, size=v.shape)).astype(np.float32),
        vs["batch_stats"])
    # widen the logits (std ~0.02 at init) so the density spans (0, 1) and
    # the comparison below sees every layer, not a flat 0.5
    out = params["OutConv_0"]["TorchConv_0"]["Conv_0"]
    out["kernel"] = out["kernel"] * 50.0
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(model.apply(variables, jnp.asarray(x), jnp.asarray(y), train=False))
    return variables, x, y, want


def test_eval_forward_matches_jax(pair):
    variables, x, y, want = pair
    net = Segmentor(3)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(y).permute(0, 3, 1, 2))
    assert got.shape == (2, 1, 32, 32) and got.dtype == torch.float32
    # the JAX package's torch-golden bound (tests/test_torch_parity.py:203)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=5e-4)


def test_state_dict_equals_jax_unit_map(pair):
    variables, _, _, _ = pair
    ours = from_jax_variables(variables)
    theirs = variables_to_torch(variables["params"], variables["batch_stats"])
    assert list(ours) == list(theirs)
    assert set(ours) == set(Segmentor(3).state_dict())
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])


def test_gated_convs_route_through_kernel_wrapper(monkeypatch, pair):
    """inc conv1, inc conv2 and down1 conv1 pass the gate; nothing else."""
    variables, x, y, _ = pair
    calls = []
    real = layers.conv3x3

    def spy(a, w):
        calls.append((tuple(a.shape), tuple(w.shape)))
        return real(a, w)

    monkeypatch.setattr(layers, "conv3x3", spy)
    net = Segmentor(3).eval()
    net.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y).permute(0, 3, 1, 2))
    assert calls == [((4, 32, 32, 3), (3, 3, 3, 64)), ((4, 32, 32, 64), (3, 3, 64, 64)),
                     ((4, 16, 16, 64), (3, 3, 64, 128))]


def test_bf16_forward_stays_close(pair):
    variables, x, y, want = pair
    net = Segmentor(3, compute_dtype=torch.bfloat16).eval()
    net.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(y).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    # bf16 keeps 8 significand bits through ~20 layers: a loose sanity bound
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() < 0.1
