"""The port's 3x3 conv: plain version against the JAX Pallas kernel and the
wrapper's checks. The CUDA kernel's own test is tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fcdgan_tpu.ops.pallas.conv3x3 import conv3x3_pallas_interpret
from fcdgan_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, gate


def _inputs(shape, seed=0):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = rng.normal(size=(3, 3, ci, co)).astype(np.float32)
    return x, k


# the JAX kernel test's shapes (tests/test_pallas_conv3x3.py) + a 3-band one
@pytest.mark.parametrize("shape", [(2, 20, 24, 8, 16), (1, 22, 20, 64, 64),
                                   (2, 16, 18, 3, 64)])
def test_plain_matches_pallas_interpret(shape):
    x, k = _inputs(shape)
    want = np.asarray(conv3x3_pallas_interpret(jnp.asarray(x), jnp.asarray(k)))
    got = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    # atol of the JAX kernel test (tests/test_pallas_conv3x3.py:20)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_wrapper_runs_plain_version_on_cpu():
    x, k = _inputs((2, 12, 9, 8, 16), seed=1)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    before = conv3x3.launches
    assert torch.equal(conv3x3(xt, kt), conv3x3_plain(xt, kt))
    assert conv3x3.launches == before  # no kernel on the CPU
    xb, kb = xt.bfloat16(), kt.bfloat16()
    out = conv3x3(xb, kb)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 12, 9, 16)


@pytest.mark.parametrize("h,w,ci,co,ok", [
    (220, 220, 3, 64, True), (220, 220, 64, 64, True), (110, 110, 64, 128, True),
    (8, 8, 64, 128, True), (55, 55, 128, 128, False), (220, 220, 64, 129, False),
    (7, 220, 8, 8, False), (220, 7, 8, 8, False), (220, 220, 65, 64, False)])
def test_gate_is_the_jax_gate(h, w, ci, co, ok):
    assert gate(h, w, ci, co) is ok


@pytest.mark.parametrize("case", ["rank", "dtype", "mixed_dtype", "noncontig",
                                  "gate", "channels", "kernel_shape"])
def test_wrapper_raises_on_bad_input(case):
    x = torch.zeros(1, 10, 10, 8)
    w = torch.zeros(3, 3, 8, 16)
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x, w = x.half(), w.half()
    elif case == "mixed_dtype":
        w = w.bfloat16()
    elif case == "noncontig":
        x = torch.zeros(1, 10, 8, 10).transpose(2, 3)
    elif case == "gate":
        x, w = torch.zeros(1, 10, 10, 96), torch.zeros(3, 3, 96, 16)
    elif case == "channels":
        w = torch.zeros(3, 3, 4, 16)
    elif case == "kernel_shape":
        w = torch.zeros(5, 5, 8, 16)
    with pytest.raises((ValueError, TypeError)):
        conv3x3(x, w)
