"""The port's SSIM / MS-SSIM against the JAX package's: the plain fused-level
composite against the Pallas kernel in interpret mode and the XLA composite,
MS-SSIM values and gradients. The CUDA kernel's own test is in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.ops import ssim as jssim
from fcdgan_tpu.ops.pallas.fused_ssim import ssim_level_interpret
from fcdgan_tpu_torch.ops import ssim as tssim
from fcdgan_tpu_torch.ops.fused_ssim import ssim_level, ssim_level_plain

ATOL = 2e-5  # the JAX kernel test's tolerance (tests/test_pallas_ssim.py)


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + rng.normal(scale=0.08, size=shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("shape", [(2, 40, 48, 3), (1, 11, 11, 3), (3, 23, 17, 2)])
def test_plain_level_matches_pallas_interpret_and_composite(shape):
    x, y = _pair(shape)
    got_s, got_cs = ssim_level_plain(torch.from_numpy(x), torch.from_numpy(y), 1.0)
    want_s, want_cs = ssim_level_interpret(jnp.asarray(x), jnp.asarray(y), 1.0)
    win = jnp.asarray(jssim.gaussian_window(11, 1.5))
    comp_s, comp_cs = jssim._ssim_maps(jnp.asarray(x), jnp.asarray(y), 1.0, win)
    for got, want in ((got_s, want_s), (got_cs, want_cs), (got_s, comp_s),
                      (got_cs, comp_cs)):
        assert tuple(got.shape) == (shape[0], shape[3])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_gaussian_window_is_the_jax_window():
    np.testing.assert_array_equal(tssim.gaussian_window(11, 1.5),
                                  jssim.gaussian_window(11, 1.5))


def test_wrapper_runs_plain_version_on_cpu():
    x, y = (torch.from_numpy(a) for a in _pair((2, 16, 20, 3), seed=1))
    before = ssim_level.launches
    for a, b in zip(ssim_level(x, y, 1.0), ssim_level_plain(x, y, 1.0)):
        assert torch.equal(a, b)
    assert ssim_level.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):  # the gate: H, W >= win_size
        ssim_level(x[:, :10], y[:, :10], 1.0)


def test_level_below_the_window_skips_the_short_axis():
    """A level shorter than the window on one axis takes the composite with
    the axis-skip rule, as the JAX package's _ssim_maps."""
    x, y = _pair((2, 8, 20, 3), seed=2)
    got = tssim._ssim_level(torch.from_numpy(x), torch.from_numpy(y), 1.0, 11, 1.5,
                            (0.01, 0.03))
    win = jnp.asarray(jssim.gaussian_window(11, 1.5))
    want = jssim._ssim_maps(jnp.asarray(x), jnp.asarray(y), 1.0, win)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("hw,weights", [(176, None), (32, (0.5, 0.5))])
def test_ms_ssim_matches_jax(hw, weights):
    x, y = _pair((2, hw, hw, 3), seed=3)
    got = tssim.ms_ssim(torch.from_numpy(x), torch.from_numpy(y), data_range=1.0,
                        size_average=False, weights=weights)
    want = jssim.ms_ssim(jnp.asarray(x), jnp.asarray(y), data_range=1.0,
                         size_average=False, weights=weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    one = tssim.ssim(torch.from_numpy(x), torch.from_numpy(y), data_range=1.0)
    np.testing.assert_allclose(float(one), float(jssim.ssim(
        jnp.asarray(x), jnp.asarray(y), data_range=1.0)), atol=ATOL)


def test_ms_ssim_too_small_raises():
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="larger than 160"):
        tssim.ms_ssim(x, x, data_range=1.0)


def test_ms_ssim_gradient_matches_jax_grad():
    """At a nonzero SSIM weight the loss is differentiated: the port's
    gradient runs through the fused-level Function's composite backward."""
    x, y = _pair((2, 32, 32, 3), seed=4)
    w = (0.5, 0.5)

    def jloss(y_):
        return jssim.ms_ssim(jnp.asarray(x), y_, data_range=1.0, weights=w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(y)))
    yt = torch.from_numpy(y).requires_grad_()
    tssim.ms_ssim(torch.from_numpy(x), yt, data_range=1.0, weights=w).backward()
    np.testing.assert_allclose(yt.grad.numpy(), want, rtol=2e-3, atol=2e-5)
