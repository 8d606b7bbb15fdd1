"""GPU kernel assertions of the port: each CUDA kernel against its plain
version on the card. Skipped without a CUDA device. This file imports no JAX,
so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fcdgan_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain


def _inputs(shape, seed=0):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = rng.normal(size=(3, 3, ci, co)).astype(np.float32)
    return x, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 20, 24, 8, 16), (1, 22, 20, 64, 64),
                                   (3, 13, 13, 3, 64), (2, 9, 27, 64, 128)])
def test_conv3x3_kernel_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, k = _inputs(shape, seed=2)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).cuda().to(dt)
    kt = torch.from_numpy(k).cuda().to(dt)
    before = conv3x3.launches
    got = conv3x3(xt, kt)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    want = conv3x3_plain(xt, kt)
    err = (got.float() - want.float()).abs().max().item()
    # f32: summation order only; bf16: one rounding of the output (1 ulp)
    tol = 2e-4 if dtype == "float32" else 2.0 ** -7 * want.float().abs().max().item()
    assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (3, 11, 9, 128), (1, 5, 7, 3),
                                   (2, 27, 27, 512), (4, 3, 6, 8)])
def test_pool_bwd_kernel_is_bit_equal_to_plain(shape, dtype):
    """Bit-equal routing, ReLU-style ties included, odd extents zeroed; and
    equal to torch's own max-pool backward, which routes the same way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.pool_bwd import max_pool_2x2, pool_bwd, pool_bwd_plain

    rng = np.random.default_rng(3)
    x = np.maximum(rng.normal(size=shape), 0).astype(np.float32)  # many 0-ties
    x[..., ::5] = np.round(x[..., ::5])  # ties between nonzero values too
    n, h, w, c = shape
    dy = rng.normal(size=(n, h // 2, w // 2, c)).astype(np.float32)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).cuda().to(dt)
    dyt = torch.from_numpy(dy).cuda().to(dt)
    before = pool_bwd.launches
    got = pool_bwd(xt, dyt)
    torch.cuda.synchronize()
    assert pool_bwd.launches == before + 1
    assert torch.equal(got, pool_bwd_plain(xt, dyt))
    xa = xt.permute(0, 3, 1, 2).requires_grad_()
    torch.nn.functional.max_pool2d(xa, 2).backward(dyt.permute(0, 3, 1, 2))
    xb = xt.permute(0, 3, 1, 2).requires_grad_()
    max_pool_2x2(xb).backward(dyt.permute(0, 3, 1, 2))
    assert torch.equal(xb.grad, xa.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 40, 48, 3), (3, 11, 11, 3), (1, 70, 33, 4)])
def test_fused_ssim_kernel_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level, ssim_level_plain

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(4)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + rng.normal(scale=0.08, size=shape), 0, 1).astype(np.float32)
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    before = ssim_level.launches
    got = ssim_level(xt, yt, 1.0)
    torch.cuda.synchronize()
    assert ssim_level.launches == before + 1
    want = ssim_level_plain(xt, yt, 1.0)
    for g, wnt in zip(got, want):
        assert g.shape == shape[:1] + shape[3:]
        # the JAX kernel test's tolerance (tests/test_pallas_ssim.py)
        assert (g - wnt).abs().max().item() <= 2e-5
    again = ssim_level(xt, yt, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
