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
