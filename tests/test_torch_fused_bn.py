"""The port's train-mode BatchNorm (``ops.fused_bn.bn_train``, a custom
autograd function on the channel-sum kernels, their plain versions on the
CPU) against the JAX package's ``ops/fused_bn.py::bn_train``, and a whole
train-mode DoubleConv against the JAX one with and without
``FCDGAN_FUSED_BN=1``. Tolerances are those of ``tests/test_fused_bn.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.models.layers import DoubleConv as JaxDoubleConv
from fcdgan_tpu.ops.fused_bn import bn_train as jax_bn_train
from fcdgan_tpu_torch.models.layers import DoubleConv
from fcdgan_tpu_torch.ops.fused_bn import bn_train


def _inputs(shape, seed, mean=0.3):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(mean, 1.5, size=shape).astype(np.float32)
    scale = (rng.normal(size=(c,)) ** 2 + 0.5).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, dy


def _nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> channels_last NCHW tensor."""
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _port(x, scale, bias, dy, dtype=torch.float32):
    xt = _nchw(x, dtype).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y, mean, var = bn_train(xt, st, bt, 1e-5)
    y.backward(_nchw(dy, dtype))
    return y, mean, var, xt.grad, st.grad, bt.grad


def _jax(x, scale, bias, dy):
    def f(x_, s_, b_):
        y, _, _ = jax_bn_train(x_, s_, b_, 1, 1e-5, None, jnp.float32)
        return jnp.sum(y * dy)

    y, mean, var = jax_bn_train(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1,
                                1e-5, None, jnp.float32)
    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                           jnp.asarray(bias))
    return (np.asarray(y), np.asarray(mean), np.asarray(var), *map(np.asarray, grads))


@pytest.mark.parametrize("shape", [(2, 6, 10, 8), (3, 5, 7, 64), (4, 3, 3, 128)])
def test_bn_train_matches_jax_values_and_vjp(shape):
    x, scale, bias, dy = _inputs(shape, seed=shape[-1])
    y, mean, var, dx, dscale, dbias = _port(x, scale, bias, dy)
    jy, jmean, jvar, jdx, jdscale, jdbias = _jax(x, scale, bias, dy)
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(y), jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-5, atol=1e-6)
    for got, want in ((_nhwc(dx), jdx), (dscale.numpy(), jdscale), (dbias.numpy(), jdbias)):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_mean_and_var_carry_no_gradient():
    x, scale, bias, _ = _inputs((2, 4, 4, 8), seed=1)
    xt = _nchw(x).requires_grad_()
    y, mean, var = bn_train(xt, torch.from_numpy(scale).requires_grad_(),
                            torch.from_numpy(bias), 1e-5)
    assert y.requires_grad
    assert not mean.requires_grad and not var.requires_grad
    assert mean.dtype == var.dtype == torch.float32


def test_bf16_against_the_f32_reference():
    """bf16 activations, f32 statistics, dx evaluated in f32 and rounded once:
    within bf16 rounding of the f32 result, also at |mean| >> std where b*x
    and d cancel."""
    x, scale, bias, dy = _inputs((3, 8, 6, 64), seed=2, mean=20.0)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())  # bf16-exact
    dy = np.asarray(torch.from_numpy(dy).to(torch.bfloat16).float())
    y, mean, var, dx, dscale, dbias = _port(x, scale, bias, dy, torch.bfloat16)
    assert y.dtype == dx.dtype == torch.bfloat16
    jy, jmean, jvar, jdx, jdscale, jdbias = _jax(x, scale, bias, dy)
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), jvar, rtol=1e-4)
    np.testing.assert_allclose(dscale.numpy(), jdscale, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(dbias.numpy(), jdbias, rtol=1e-5, atol=1e-4)
    # y: the bf16 (x - mean) and the bf16 coefficients, a few roundings
    assert np.abs(_nhwc(y) - jy).max() <= 2.0 ** -6 * np.abs(jy).max()
    # dx: one rounding of the f32 value
    assert np.all(np.abs(_nhwc(dx) - jdx) <= 2.0 ** -8 * np.abs(jdx) + 1e-6)


def _port_doubleconv(variables, x):
    p, bs = variables["params"], variables["batch_stats"]
    net = DoubleConv(x.shape[-1], 16)
    sd = {}
    for i, (tc, tb) in enumerate(((0, 1), (3, 4))):
        k = np.asarray(p[f"TorchConv_{i}"]["Conv_0"]["kernel"])
        sd[f"double_conv.{tc}.weight"] = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy())
        sd[f"double_conv.{tc}.bias"] = torch.from_numpy(
            np.array(p[f"TorchConv_{i}"]["Conv_0"]["bias"]))
        bn, st = p[f"BatchNorm_{i}"]["BatchNorm_0"], bs[f"BatchNorm_{i}"]["BatchNorm_0"]
        for name, v in (("weight", bn["scale"]), ("bias", bn["bias"]),
                        ("running_mean", st["mean"]), ("running_var", st["var"])):
            sd[f"double_conv.{tb}.{name}"] = torch.from_numpy(np.array(v))
        sd[f"double_conv.{tb}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    net.load_state_dict(sd, strict=True)
    net.train()
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    y = net(xt)
    loss = y.square().sum()
    loss.backward()
    grads = {i: {"kernel": np.transpose(net.double_conv[tc].weight.grad.numpy(), (2, 3, 1, 0)),
                 "scale": net.double_conv[tb].weight.grad.numpy(),
                 "bias": net.double_conv[tb].bias.grad.numpy()}
             for i, (tc, tb) in enumerate(((0, 1), (3, 4)))}
    stats = {i: (net.double_conv[tb].running_mean.numpy(),
                 net.double_conv[tb].running_var.numpy())
             for i, tb in enumerate((1, 4))}
    assert all(net.double_conv[tc].bias.grad is None for tc in (0, 3))  # folded
    return float(loss.detach()), stats, grads


def _grads_close(a, b):
    """test_fused_bn.py:111-122: ReLU gates flipped by rounding between two
    lowerings reroute a tiny fraction of the elements."""
    scale = max(np.abs(b).max(), 1e-3)
    diff = np.abs(a - b)
    assert diff.mean() <= 0.01 * scale
    assert int((diff > 0.03 * scale).sum()) <= max(3, b.size // 200)
    assert diff.max() <= 0.5 * scale


@pytest.mark.parametrize("fused", [True, False], ids=["FCDGAN_FUSED_BN=1", "default"])
def test_doubleconv_train_step_matches_jax(fused, monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    if fused:
        monkeypatch.setenv("FCDGAN_FUSED_BN", "1")
    else:
        monkeypatch.delenv("FCDGAN_FUSED_BN", raising=False)
    m = JaxDoubleConv(16)
    v = m.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), True)

    def loss(p):
        y, mut = m.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                         True, mutable=["batch_stats"])
        return jnp.sum(jnp.square(y)), mut["batch_stats"]

    (jl, jbs), jg = jax.value_and_grad(loss, has_aux=True)(v["params"])
    pl, stats, grads = _port_doubleconv(jax.tree.map(np.asarray, v), x)

    np.testing.assert_allclose(pl, float(jl), rtol=1e-5)
    for i in range(2):
        st = jbs[f"BatchNorm_{i}"]["BatchNorm_0"]
        np.testing.assert_allclose(stats[i][0], np.asarray(st["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(stats[i][1], np.asarray(st["var"]), rtol=1e-5, atol=1e-6)
        _grads_close(grads[i]["kernel"], np.asarray(jg[f"TorchConv_{i}"]["Conv_0"]["kernel"]))
        bn = jg[f"BatchNorm_{i}"]["BatchNorm_0"]
        _grads_close(grads[i]["scale"], np.asarray(bn["scale"]))
        _grads_close(grads[i]["bias"], np.asarray(bn["bias"]))
        np.testing.assert_array_equal(np.asarray(jg[f"TorchConv_{i}"]["Conv_0"]["bias"]), 0.0)
