"""The port's max-pool backward against the JAX package's pool_bwd_reference:
bit-equal, ties and odd extents included. The CUDA kernel's own test is in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fcdgan_tpu.ops.pallas.pool_bwd import pool_bwd_reference
from fcdgan_tpu_torch.ops.pool_bwd import max_pool_2x2, pool_bwd, pool_bwd_plain

SHAPES = [(2, 8, 8, 3), (1, 7, 9, 4), (3, 6, 6, 1), (2, 5, 5, 8), (2, 10, 13, 64)]


def _x(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "relu":  # the ReLU zeros of the Segmentor and VGG: ties everywhere
        return np.maximum(rng.normal(size=shape), 0).astype(np.float32)
    return rng.integers(0, 2, size=shape).astype(np.float32)  # forced ties


def _bits(a) -> np.ndarray:
    """float32 bit patterns, so +0 and -0 differ."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "relu", "ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_and_autograd_bit_equal_to_jax_reference(shape, kind, dtype):
    x = _x(shape, kind, seed=len(shape) + shape[1])
    n, h, w, c = shape
    dy = np.random.default_rng(1).normal(size=(n, h // 2, w // 2, c)).astype(np.float32)
    want = pool_bwd_reference(jnp.asarray(x, dtype), jnp.asarray(dy, dtype))
    want = _bits(np.asarray(want.astype(jnp.float32)))

    dt = getattr(torch, dtype)
    xt, dyt = torch.from_numpy(x).to(dt), torch.from_numpy(dy).to(dt)
    got = pool_bwd_plain(xt, dyt)
    assert got.dtype == dt and got.shape == xt.shape
    np.testing.assert_array_equal(_bits(got.float().numpy()), want)

    # the autograd path the models take: NCHW channels_last through max_pool_2x2
    xa = xt.permute(0, 3, 1, 2).requires_grad_()
    out = max_pool_2x2(xa)
    assert torch.equal(out, torch.nn.functional.max_pool2d(xa.detach(), 2))
    out.backward(dyt.permute(0, 3, 1, 2))
    np.testing.assert_array_equal(
        _bits(xa.grad.permute(0, 2, 3, 1).float().numpy()), want)


def test_wrapper_runs_plain_version_on_cpu():
    x = torch.from_numpy(_x((2, 6, 7, 4), "ties", 3))
    dy = torch.ones(2, 3, 3, 4)
    before = pool_bwd.launches
    assert torch.equal(pool_bwd(x, dy), pool_bwd_plain(x, dy))
    assert pool_bwd.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("case", ["rank", "shape", "dtype", "mixed", "noncontig"])
def test_wrapper_raises_on_bad_input(case):
    x, dy = torch.zeros(1, 4, 4, 8), torch.zeros(1, 2, 2, 8)
    if case == "rank":
        x = x[0]
    elif case == "shape":
        dy = torch.zeros(1, 3, 2, 8)
    elif case == "dtype":
        x, dy = x.half(), dy.half()
    elif case == "mixed":
        dy = dy.bfloat16()
    elif case == "noncontig":
        x = torch.zeros(1, 4, 8, 4).transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        pool_bwd(x, dy)
