"""The port's 2x2 max-pool forward (``ops.phase_pool``, its plain version on
CPU tensors) against the JAX package's ``phase_pool_forward`` (the Pallas
kernel in interpret mode) and ``phase_pool_reference`` on the W-phase view
of the same NHWC activation: bit-equal, ReLU ties, odd extents and bf16
included; and ``max_pool_2x2`` against ``F.max_pool2d``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from fcdgan_tpu.ops.pallas.phase_pool import phase_pool_forward, phase_pool_reference
from fcdgan_tpu_torch.ops.phase_pool import phase_pool
from fcdgan_tpu_torch.ops.pool_bwd import max_pool_2x2

SHAPES = [(2, 8, 8, 64), (1, 9, 7, 128), (2, 5, 11, 8), (1, 34, 6, 4), (3, 3, 2, 16)]


def _relu_ties(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=shape), 0).astype(np.float32)  # many tied zeros
    x[..., ::3] = np.round(x[..., ::3])  # ties between nonzero values too
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_phase_pool_is_bit_equal_to_the_jax_kernel(shape, dtype):
    x = _relu_ties(shape, seed=sum(shape))
    xt = torch.from_numpy(x).to(dtype)
    got = phase_pool(xt)
    n, h, w, c = shape
    assert got.shape == (n, h // 2, w // 2, c) and got.dtype == dtype
    # the JAX function's (N, H, W/2, 2C) input: the phase view of the even
    # columns (an odd W drops its last column)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    view = jnp.asarray(x[:, :, :2 * (w // 2), :].reshape(n, h, w // 2, 2 * c)).astype(jdt)
    got32 = got.float().numpy()
    np.testing.assert_array_equal(got32, np.asarray(phase_pool_forward(view, interpret=True),
                                                    np.float32))
    np.testing.assert_array_equal(got32, np.asarray(phase_pool_reference(view), np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_max_pool_2x2_equals_torch_forward_and_backward(shape, dtype):
    x = torch.from_numpy(_relu_ties(shape, seed=1)).to(dtype).permute(0, 3, 1, 2)
    dy = torch.from_numpy(np.random.default_rng(2).normal(
        size=(shape[0], shape[3], shape[1] // 2, shape[2] // 2)).astype(np.float32)).to(dtype)
    xa = x.detach().requires_grad_()
    xb = x.detach().requires_grad_()
    want = F.max_pool2d(xa, 2)
    got = max_pool_2x2(xb)
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want.backward(dy)
    got.backward(dy)
    assert torch.equal(xb.grad, xa.grad)


@pytest.mark.parametrize("bad", ["3d", "int", "strided"])
def test_wrapper_raises_on_bad_input(bad):
    x = torch.zeros(2, 4, 4, 8)
    with pytest.raises((ValueError, TypeError)):
        if bad == "3d":
            phase_pool(x[0])
        elif bad == "int":
            phase_pool(x.to(torch.int32))
        else:
            phase_pool(x.permute(0, 2, 1, 3))
