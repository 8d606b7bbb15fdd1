"""The port's channel_sums / channel_sums_pair (their plain versions, which the
wrappers run on CPU tensors) against the TPU kernel bodies themselves: a
``pl.pallas_call`` built here, in interpret mode, from the JAX module's own
``_sum_kernel`` / ``_pair_kernel``, ``_flat_view``, ``_rows_block`` and
``_fold``, with a row block that leaves a ragged last block; and against the
jnp branches ``fused_bn._moment_sums`` / ``_pair_sums``.

Tolerance: |got - want| <= 1e-5 * sum|x| per channel (sum x^2 for the
squares, sum |a*b| for the pair): the two sum in other orders."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from fcdgan_tpu.ops import fused_bn as jfused
from fcdgan_tpu.ops.pallas import channel_sums as jcs
from fcdgan_tpu_torch.ops.channel_sums import channel_sums, channel_sums_pair

# (N, H, W): N*H*W rows is even (C = 64 packs two pixels per 128-lane row)
# and leaves a ragged last block of the 16-row blocks below
SHAPES = [(2, 5, 7), (2, 9, 5)]


def _interpret_sums(kernel, arrays, c, blk_rows, **kw):
    """The JAX kernel body over its flat lane-aligned view, as channel_sums /
    channel_sums_pair call it (channel_sums.py:100-144), in interpret mode."""
    flats = [jcs._flat_view(a) for a in arrays]
    rows, phases = flats[0][1], flats[0][2]
    width = flats[0][0].shape[1]
    n_out = 2 if (kw.get("square") or len(arrays) == 2) else 1
    blk = jcs._rows_block(width, arrays[0].dtype.itemsize,
                          target_bytes=blk_rows * width * arrays[0].dtype.itemsize)
    assert rows % blk, "the test wants a ragged last block"
    out = pl.pallas_call(
        functools.partial(kernel, n_rows=rows, **kw),
        grid=(pl.cdiv(rows, blk),),
        in_specs=[pl.BlockSpec((blk, width), lambda i: (i, 0)) for _ in arrays],
        out_specs=pl.BlockSpec((n_out, width), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((n_out, width), jnp.float32),
        interpret=True,
    )(*[f[0] for f in flats])
    return [np.asarray(jcs._fold(out[k], c, phases)) for k in range(n_out)]


def _inputs(shape, c, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(0.7, 2.0, size=shape + (c,)).astype(np.float32)
    b = rng.normal(size=shape + (c,)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ta, tb, jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)


def _close(got, want, scale):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert np.all(np.abs(got - np.asarray(want)) <= 1e-5 * np.asarray(scale) + 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("shape", SHAPES, ids=["2x5x7", "2x9x5"])
def test_channel_sums_match_the_tpu_kernel_bodies(shape, c, dtype):
    ta, tb, ja, jb = _inputs(shape, c, dtype, seed=c)
    af = ta.float().reshape(-1, c)
    bf = tb.float().reshape(-1, c)
    s, ss = channel_sums(ta, square=True)
    s_only = channel_sums(ta)
    sa, sab = channel_sums_pair(ta, tb)
    scale_a, scale_sq = af.abs().sum(0).numpy(), af.square().sum(0).numpy()
    scale_ab = (af * bf).abs().sum(0).numpy()

    ks, kss = _interpret_sums(jcs._sum_kernel, [ja], c, 16, square=True)
    (ks_only,) = _interpret_sums(jcs._sum_kernel, [ja], c, 16, square=False)
    kpa, kpab = _interpret_sums(jcs._pair_kernel, [ja, jb], c, 16)
    for got, want, scale in ((s, ks, scale_a), (ss, kss, scale_sq),
                             (s_only, ks_only, scale_a), (sa, kpa, scale_a),
                             (sab, kpab, scale_ab)):
        assert got.dtype == torch.float32 and got.shape == (c,)
        _close(got, want, scale)

    ms, mss = jfused._moment_sums(ja)  # the jnp branches the kernels replace
    ps, psab = jfused._pair_sums(ja, jb)
    for got, want, scale in ((s, ms, scale_a), (ss, mss, scale_sq), (sa, ps, scale_a),
                             (sab, psab, scale_ab)):
        _close(got, want, scale)


@pytest.mark.parametrize("case", ["1d", "dtype", "shape", "int"])
def test_wrappers_raise_on_bad_input(case):
    x = torch.zeros(2, 4, 4, 8)
    with pytest.raises((ValueError, TypeError)):
        if case == "1d":
            channel_sums(torch.zeros(8))
        elif case == "dtype":
            channel_sums_pair(x, x.to(torch.bfloat16))
        elif case == "shape":
            channel_sums_pair(x, torch.zeros(2, 4, 4, 16))
        else:
            channel_sums(x.to(torch.int32))
