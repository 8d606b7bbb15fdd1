"""GPU kernel assertions of the port: each CUDA kernel against its plain
version on the card. Skipped without a CUDA device. This file imports no JAX,
so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

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


def _conv_on_card(shape, dtype, seed=2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, k = _inputs(shape, seed=seed)
    dt = getattr(torch, dtype)
    return torch.from_numpy(x).cuda().to(dt), torch.from_numpy(k).cuda().to(dt)


def _assert_conv_matches_plain(xt, kt, got):
    want = conv3x3_plain(xt, kt)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    # f32: summation order only; bf16: one rounding of the output (1 ulp)
    tol = (2e-4 if xt.dtype == torch.float32
           else 2.0 ** -7 * want.float().abs().max().item())
    assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 20, 24, 8, 16), (1, 22, 20, 64, 64),
                                   (3, 13, 13, 3, 64), (2, 9, 27, 64, 128)])
def test_conv3x3_kernel_matches_plain(shape, dtype):
    xt, kt = _conv_on_card(shape, dtype)
    before = conv3x3.launches
    got = conv3x3(xt, kt)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    _assert_conv_matches_plain(xt, kt, got)


# every model shape class at small N (C_in 3 and 64, C_out 64 and 128), ragged
# edges (W 220, 27, 9; H 8), C_out 16 and 24, C_in 8 (TMA with the channels
# zero-filled to 64), odd widths on both loaders, and batches with several
# tiles per persistent block (3 x 220 x 220: 2352 tiles on 132 SMs), for the
# gather also at 4, 5 and 9 K blocks a tile (C_in 25, 33, 63)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 16, 32, 3, 64), (2, 16, 32, 64, 64), (2, 16, 32, 64, 128), (2, 16, 32, 3, 128),
    (1, 12, 220, 64, 64), (2, 19, 27, 64, 128), (3, 8, 9, 3, 64), (2, 8, 40, 64, 64),
    (2, 20, 24, 64, 16), (2, 20, 24, 3, 24), (2, 17, 23, 8, 64), (2, 11, 13, 5, 7),
    (1, 9, 10, 40, 33), (1, 10, 9, 63, 128), (3, 220, 220, 64, 64),
    (2, 200, 200, 3, 64), (4, 64, 72, 33, 64), (3, 220, 220, 63, 128),
    (16, 64, 72, 25, 24)])
def test_conv3x3_wgmma_matches_plain(shape):
    xt, kt = _conv_on_card(shape, "bfloat16", seed=3)
    before = dict(conv3x3.launches_by_variant)
    got = conv3x3(xt, kt)
    torch.cuda.synchronize()
    assert conv3x3.launches_by_variant == {**before, "wgmma": before["wgmma"] + 1}
    _assert_conv_matches_plain(xt, kt, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kind", [("bfloat16", "wgmma"), ("float32", "fma_f32")])
@pytest.mark.parametrize("shape", [(4, 64, 72, 64, 128), (4, 64, 72, 3, 64),
                                   (16, 64, 72, 25, 24)])
def test_conv3x3_is_bitwise_repeatable(shape, dtype, kind):
    xt, kt = _conv_on_card(shape, dtype, seed=4)
    before = conv3x3.launches_by_variant[kind]
    a, b = conv3x3(xt, kt), conv3x3(xt, kt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert conv3x3.launches_by_variant[kind] == before + 2


@pytest.mark.cuda
def test_conv3x3_wgmma_raises_on_misaligned_input():
    xt, kt = _conv_on_card((1, 8, 8, 64, 64), "bfloat16")
    buf = torch.zeros(xt.numel() + 1, dtype=xt.dtype, device="cuda")
    shifted = buf[1:].view(xt.shape)  # contiguous, 2 bytes past a 16-byte boundary
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = conv3x3.launches
    with pytest.raises(ValueError, match="aligned"):
        conv3x3(shifted, kt)
    assert conv3x3.launches == before


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
    if (c * xt.element_size()) % 16:  # the phase_pool forward takes whole 16-byte rows
        with pytest.raises(ValueError, match="16-byte vectors"):
            max_pool_2x2(xt.permute(0, 3, 1, 2))
        return
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 20, 24, 64), (3, 11, 9, 128), (1, 13, 13, 512),
                                   (2, 5, 7, 1024), (1, 3, 3, 8)])
def test_channel_sums_kernels_match_plain(shape, dtype):
    """Both sum kernels against their plain versions at the tolerance of the
    CPU tests (1e-5 of the sum of magnitudes), and bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.channel_sums import (channel_sums, channel_sums_pair,
                                                   channel_sums_pair_plain,
                                                   channel_sums_plain)

    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    a = torch.from_numpy(rng.normal(1.0, 2.0, size=shape).astype(np.float32)).cuda().to(dt)
    b = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dt)
    before = (channel_sums.launches, channel_sums_pair.launches)
    got = (*channel_sums(a, square=True), channel_sums(a), *channel_sums_pair(a, b))
    torch.cuda.synchronize()
    assert (channel_sums.launches, channel_sums_pair.launches) == (before[0] + 2,
                                                                   before[1] + 1)
    af, bf = a.float().reshape(-1, shape[-1]), b.float().reshape(-1, shape[-1])
    want = (*channel_sums_plain(a, square=True), channel_sums_plain(a),
            *channel_sums_pair_plain(a, b))
    scale = (af.abs().sum(0), af.square().sum(0), af.abs().sum(0), af.abs().sum(0),
             (af * bf).abs().sum(0))
    for g, w, s in zip(got, want, scale):
        assert bool(((g - w).abs() <= 1e-5 * s + 1e-30).all())
    again = (*channel_sums(a, square=True), channel_sums(a), *channel_sums_pair(a, b))
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_on_cuda_launches_both_sum_kernels(dtype):
    """A train-mode BN forward and backward on the card: one launch of each
    sum kernel, results as the same BN on the CPU (the plain sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.channel_sums import channel_sums, channel_sums_pair
    from fcdgan_tpu_torch.ops.fused_bn import bn_train

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0.5, 1.5, size=(4, 64, 12, 10)).astype(np.float32)
                         ).contiguous(memory_format=torch.channels_last)
    dy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, size=64).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).to(getattr(torch, dtype)).requires_grad_()
        sd, bd = scale.to(dev).requires_grad_(), bias.to(dev).requires_grad_()
        before = (channel_sums.launches, channel_sums_pair.launches)
        y, mean, var = bn_train(xd, sd, bd, 1e-5)
        y.backward(dy.to(dev).to(y.dtype).contiguous(memory_format=torch.channels_last))
        launched = (channel_sums.launches - before[0], channel_sums_pair.launches - before[1])
        assert launched == ((1, 1) if dev == "cuda" else (0, 0))
        out[dev] = [t.detach().float().cpu() for t in (y, mean, var, xd.grad, sd.grad,
                                                       bd.grad)]
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, c in zip(out["cuda"], out["cpu"]):
        assert (g - c).abs().max().item() <= tol * max(1.0, c.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (3, 11, 9, 128), (2, 27, 27, 512),
                                   (4, 3, 6, 8), (2, 25, 25, 256), (1, 5, 7, 64)])
def test_phase_pool_kernel_is_bit_equal_to_plain(shape, dtype):
    """Bit-equal to its plain version and to F.max_pool2d, ReLU-style ties
    included, odd extents floored; max_pool_2x2 launches it once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.phase_pool import phase_pool, phase_pool_plain
    from fcdgan_tpu_torch.ops.pool_bwd import max_pool_2x2

    rng = np.random.default_rng(7)
    x = np.maximum(rng.normal(size=shape), 0).astype(np.float32)
    x[..., ::5] = np.round(x[..., ::5])
    xt = torch.from_numpy(x).cuda().to(getattr(torch, dtype))
    before = phase_pool.launches
    got = phase_pool(xt)
    torch.cuda.synchronize()
    assert phase_pool.launches == before + 1
    assert torch.equal(got, phase_pool_plain(xt))
    lib = torch.nn.functional.max_pool2d(xt.permute(0, 3, 1, 2), 2)
    assert torch.equal(got.permute(0, 3, 1, 2), lib)
    assert torch.equal(max_pool_2x2(xt.permute(0, 3, 1, 2)), lib)
    assert phase_pool.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 96, 96, 64), (8, 96, 96, 128)])
def test_channel_sums_kernels_count_every_row(shape, dtype):
    """Blocks of more rows than one batch of loads, so the unrolled main
    loop runs, then the predicated last batch. Small integers make every
    partial sum exact in f32 in any order, so the sums must equal the
    float64 sums exactly: one row lost or read twice moves a channel's sum
    by at least 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.channel_sums import (channel_sums, channel_sums_pair,
                                                   reduction_plan)

    dt = getattr(torch, dtype)
    rows, c = int(np.prod(shape[:-1])), shape[-1]
    itemsize = torch.empty((), dtype=dt).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = reduction_plan(rows, c, itemsize, sms)
    assert plan.rows_per_block > 16 * plan.row_lanes  # 16 loads in flight a thread
    rng = np.random.default_rng(8)
    a = rng.integers(1, 5, size=shape).astype(np.float64)
    b = rng.integers(1, 5, size=shape).astype(np.float64)
    at, bt = (torch.from_numpy(v.astype(np.float32)).cuda().to(dt) for v in (a, b))
    got = (*channel_sums(at, square=True), *channel_sums_pair(at, bt))
    a2, b2 = a.reshape(-1, c), b.reshape(-1, c)
    want = (a2.sum(0), np.square(a2).sum(0), a2.sum(0), (a2 * b2).sum(0))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), torch.from_numpy(w.astype(np.float32)))


def _sums_on_card(shape, dtype, seed):
    from fcdgan_tpu_torch.ops.channel_sums import channel_sums, channel_sums_pair

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    a = torch.from_numpy(rng.normal(0.5, 2.0, size=shape).astype(np.float32)).cuda().to(dt)
    b = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dt)
    return a, b, lambda: (channel_sums(a), *channel_sums(a, square=True),
                          *channel_sums_pair(a, b))


def _assert_sums_match_plain(a, b, got):
    from fcdgan_tpu_torch.ops.channel_sums import channel_sums_pair_plain, channel_sums_plain

    c = a.shape[-1]
    af, bf = a.float().reshape(-1, c), b.float().reshape(-1, c)
    want = (channel_sums_plain(a), *channel_sums_plain(a, square=True),
            *channel_sums_pair_plain(a, b))
    scale = (af.abs().sum(0), af.abs().sum(0), af.square().sum(0), af.abs().sum(0),
             (af * bf).abs().sum(0))
    for g, w, s in zip(got, want, scale):
        assert g.shape == (c,)
        assert bool(((g - w).abs() <= 1e-5 * s + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 8), (1, 1, 1, 64), (1, 1, 1, 1024),
                                   (2, 3, 3, 1024), (20, 220, 220, 64), (30, 13, 13, 512),
                                   (2, 9, 9, 96)])
def test_channel_sums_one_launch_bitwise_repeatable(shape, dtype):
    """One row, C = 1024, a partly filled last channel tile (96 bf16
    channels), the largest BN input: within the tolerance of the plain sums,
    and three calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b, calls = _sums_on_card(shape, dtype, seed=9)
    runs = [[t.clone() for t in calls()] for _ in range(3)]
    torch.cuda.synchronize()
    _assert_sums_match_plain(a, b, runs[0])
    assert all(torch.equal(x, y) for other in runs[1:] for x, y in zip(runs[0], other))


@pytest.mark.cuda
def test_channel_sums_back_to_back_and_on_two_streams():
    """Calls of different shapes queued back to back, and calls on two
    streams at once: each stream has its own ticket counters, which every
    launch leaves at 0, so every result is right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = [_sums_on_card(shape, "bfloat16", seed=10 + i)
             for i, shape in enumerate([(10, 110, 110, 128), (2, 5, 7, 1024), (20, 55, 55, 256),
                                        (1, 1, 1, 64)])]
    got = [calls() for _, _, calls in cases + cases]  # no synchronize between
    torch.cuda.synchronize()
    for (a, b, _), g in zip(cases + cases, got):
        _assert_sums_match_plain(a, b, g)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    results = []
    for _ in range(10):
        for stream, (a, b, calls) in zip(streams, cases[:2]):
            with torch.cuda.stream(stream):
                results.append((a, b, calls()))
    torch.cuda.synchronize()
    for a, b, g in results:
        _assert_sums_match_plain(a, b, g)


def _ssim_on_card(shape, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + rng.normal(scale=0.08, size=shape), 0, 1).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("hw", [(11, 11), (14, 14), (28, 28), (55, 55), (110, 110),
                                (220, 220), (23, 17), (70, 33)])
def test_fused_ssim_levels_match_plain(hw, c):
    """Every MS-SSIM level size of a step (11: one valid position), two
    non-square planes, one to four channels: within 2e-5 of the plain
    composite, one launch, three calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level, ssim_level_plain

    torch.backends.cudnn.allow_tf32 = False
    xt, yt = _ssim_on_card((3, *hw, c))
    before = ssim_level.launches
    runs = [[t.clone() for t in ssim_level(xt, yt, 1.0)] for _ in range(3)]
    torch.cuda.synchronize()
    assert ssim_level.launches == before + 3
    for g, w in zip(runs[0], ssim_level_plain(xt, yt, 1.0)):
        assert g.shape == (3, c)
        assert (g - w).abs().max().item() <= 2e-5
    assert all(torch.equal(a, b) for other in runs[1:] for a, b in zip(runs[0], other))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,win", [((2, 40, 48, 5), 11), ((2, 40, 48, 3), 7),
                                       ((1, 9, 30, 2), 5)])
def test_fused_ssim_more_channels_and_other_windows(shape, win):
    """Five channels (staged four at a time) and windows other than 11
    (the taps not unrolled)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level, ssim_level_plain

    torch.backends.cudnn.allow_tf32 = False
    xt, yt = _ssim_on_card(shape, seed=12)
    for g, w in zip(ssim_level(xt, yt, 1.0, win), ssim_level_plain(xt, yt, 1.0, win)):
        assert (g - w).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_redesigned_reductions_launch_once():
    """Three warm calls of channel_sums, channel_sums_pair or ssim_level put
    exactly three kernels on the card, the same one each (a torch.profiler
    trace; a trace with no device event at all was dropped and is taken
    again)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from fcdgan_tpu_torch.ops.channel_sums import channel_sums, channel_sums_pair
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level

    a, b, _ = _sums_on_card((4, 32, 32, 128), "bfloat16", seed=13)
    xt, yt = _ssim_on_card((2, 55, 55, 3))
    for fn in (lambda: channel_sums(a, square=True), lambda: channel_sums_pair(a, b),
               lambda: ssim_level(xt, yt, 1.0)):
        fn()
        torch.cuda.synchronize()
        names = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            names = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(ev, "is_user_annotation", False)]
            if names:
                break
        assert len(names) == 3 and len(set(names)) == 1, names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase_pool_raises_on_layouts_it_does_not_take(dtype):
    """A row that is not a whole number of 16-byte vectors, or an unaligned
    base, raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.ops.phase_pool import phase_pool

    dt = getattr(torch, dtype)
    before = phase_pool.launches
    with pytest.raises(ValueError, match="16-byte vectors"):
        phase_pool(torch.zeros((1, 5, 7, 3), dtype=dt, device="cuda"))
    unaligned = torch.zeros(2 * 4 * 4 * 64 + 1, dtype=dt, device="cuda")[1:]
    with pytest.raises(ValueError, match="aligned"):
        phase_pool(unaligned.view(2, 4, 4, 64))
    assert phase_pool.launches == before


# the shapes of the RSSS training path: 4 bands at 200 px, S on 2 x 12
# stacked tiles, G at 12 and 20, the per-band VGG on 4 x 12 planes

def _card_generator(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 200, 200, 4, 64), (12, 200, 200, 64, 4)],
                         ids=["S inc.conv1, C_in 4 (gather)", "C_out 4 from 64"])
def test_conv3x3_rsss_shapes(shape):
    xt, kt = _conv_on_card(shape, "bfloat16", seed=8)
    before = dict(conv3x3.launches_by_variant)
    got = conv3x3(xt, kt)
    torch.cuda.synchronize()
    assert conv3x3.launches_by_variant == {**before, "wgmma": before["wgmma"] + 1}
    _assert_conv_matches_plain(xt, kt, got)
    assert torch.equal(got, conv3x3(xt, kt))


@pytest.mark.cuda
def test_fused_ssim_rsss_level():
    """The first MS-SSIM level of an RSSS step: 12 images of 4 channels at
    200 px, one channel group of exactly four."""
    gen = _card_generator(9)
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level, ssim_level_plain

    x = torch.rand((12, 200, 200, 4), generator=gen, device="cuda")
    y = (x + 0.08 * torch.randn(x.shape, generator=gen, device="cuda")).clamp(0, 1)
    before = ssim_level.launches
    got = ssim_level(x, y, 1.0)
    torch.cuda.synchronize()
    assert ssim_level.launches == before + 1
    for g, w in zip(got, ssim_level_plain(x, y, 1.0)):
        assert g.shape == (12, 4) and (g - w).abs().max().item() <= 2e-5
    assert all(torch.equal(a, b) for a, b in zip(got, ssim_level(x, y, 1.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 200, 200, 64), (80, 200, 200, 64)])
def test_channel_sums_rsss_shapes(shape):
    """Both sum kernels in bf16 at an RSSS BN input (S on the stacked pair)
    and at 80 x 200 x 200, within 1e-5 of the sum of magnitudes, bitwise
    repeatable."""
    gen = _card_generator(10)
    from fcdgan_tpu_torch.ops.channel_sums import (channel_sums, channel_sums_pair,
                                                   channel_sums_pair_plain,
                                                   channel_sums_plain)

    a = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(torch.bfloat16)
    b = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    got = (*channel_sums(a, square=True), *channel_sums_pair(a, b))
    af, bf = a.float().reshape(-1, shape[-1]), b.float().reshape(-1, shape[-1])
    want = (*channel_sums_plain(a, square=True), *channel_sums_pair_plain(a, b))
    scale = (af.abs().sum(0), af.square().sum(0), af.abs().sum(0), (af * bf).abs().sum(0))
    for g, w, s in zip(got, want, scale):
        assert bool(((g - w).abs() <= 1e-5 * s + 1e-30).all())
    again = (*channel_sums(a, square=True), *channel_sums_pair(a, b))
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 200, 200, 64), (48, 25, 25, 512)])
def test_pools_at_rsss_vgg_batch(shape, dtype):
    """phase_pool and pool_bwd on 4 x 12 VGG planes: bit-equal to their plain
    versions."""
    gen = _card_generator(11)
    from fcdgan_tpu_torch.ops.phase_pool import phase_pool, phase_pool_plain
    from fcdgan_tpu_torch.ops.pool_bwd import pool_bwd, pool_bwd_plain

    dt = getattr(torch, dtype)
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda")).to(dt)
    n, h, w, c = shape
    dy = torch.randn((n, h // 2, w // 2, c), generator=gen, device="cuda").to(dt)
    before = (phase_pool.launches, pool_bwd.launches)
    fwd, bwd = phase_pool(x), pool_bwd(x, dy)
    torch.cuda.synchronize()
    assert (phase_pool.launches, pool_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(fwd, phase_pool_plain(x))
    assert torch.equal(bwd, pool_bwd_plain(x, dy))


@pytest.mark.cuda
def test_fused_ssim_past_1024_images():
    """A level of 1100 images (more than the 1024 ticket counters a stream
    starts with): the counter array grows, the result stays within 2e-5 of
    the plain composite, and a warm call is one device launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level, ssim_level_plain

    xt, yt = _ssim_on_card((1100, 16, 16, 3), seed=14)
    before = ssim_level.launches
    got = [t.clone() for t in ssim_level(xt, yt, 1.0)]
    torch.cuda.synchronize()
    assert ssim_level.launches == before + 1
    for g, w in zip(got, ssim_level_plain(xt, yt, 1.0)):
        assert g.shape == (1100, 3)
        assert (g - w).abs().max().item() <= 2e-5
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            again = ssim_level(xt, yt, 1.0)
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False)]
        if names:
            break
    assert len(names) == 1, names
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    small = ssim_level(xt[:7], yt[:7], 1.0)  # the grown array serves smaller levels
    for g, w in zip(small, ssim_level_plain(xt[:7], yt[:7], 1.0)):
        assert (g - w).abs().max().item() <= 2e-5


def _served_scene(tmp_path, device):
    """A small scene's resident cache and a seeded f32 Segmentor on ``device``."""
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene
    from fcdgan_tpu_torch.models.segmentor import Segmentor

    d = str(tmp_path)
    if not os.path.exists(os.path.join(d, "T1.tif")):
        make_usss_scene(d, 150, 130, 3, seed=5, dtype="uint16")
    stats_ds = ScenePairDataset(os.path.join(d, "T1.tif"), os.path.join(d, "T2.tif"),
                                patch_size=(64, 64), overlap_padding=(0, 0))
    scaler = Normalize(*dataset_meanstd(os.path.join(d, "T1_stats.txt"),
                                        os.path.join(d, "T2_stats.txt"), stats_ds))
    ds = ScenePairDataset(os.path.join(d, "T1.tif"), os.path.join(d, "T2.tif"),
                          enhance=scaler, patch_size=(64, 64), overlap_padding=(6, 6))
    torch.manual_seed(0)
    net = Segmentor(3).eval()
    with torch.no_grad():
        net.outc.conv.weight.mul_(50.0)
    return DeviceSceneCache(ds, scaler, device), net.to(device)


@pytest.mark.cuda
def test_quantized_canvas_on_the_card(tmp_path):
    """The canvas quantizer on the card gives the CPU's codes for the same
    density, and the card's uint8 / bfloat16 scene densities are within one
    quantization step of its float32 one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.utils.download import quantize

    torch.backends.cudnn.allow_tf32 = False
    d = torch.rand(257, 263, device="cuda") * 1.2 - 0.1
    for dt in ("uint8", "bfloat16"):
        assert torch.equal(quantize(d, dt).cpu(), quantize(d.cpu(), dt))
    cache, net = _served_scene(tmp_path, "cuda")
    f32 = cache.stitched_density(net, 4)
    u8 = cache.stitched_density(net, 4, "uint8")
    bf = cache.stitched_density(net, 4, "bfloat16")
    assert f32.shape == u8.shape == bf.shape == (130, 150) and f32.std() > 0.01
    assert np.abs(u8 - f32).max() <= 1 / 510 + 1e-7
    assert np.all(np.abs(bf - f32) <= 2.0 ** -8 * np.abs(f32))
    cpu_cache, cpu_net = _served_scene(tmp_path, "cpu")
    np.testing.assert_allclose(f32, cpu_cache.stitched_density(cpu_net, 4), atol=1e-3)


@pytest.mark.cuda
def test_stitched_density_start_finish_is_the_blocking_call(tmp_path):
    """Two scenes started before either is finished (the oscd pipeline)
    give the blocking call's densities bit for bit, in every download type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cache, net = _served_scene(tmp_path, "cuda")
    for dt in ("float32", "uint8", "bfloat16"):
        want = cache.stitched_density(net, 4, dt)
        first = cache.stitched_density_start(net, 4, dt)
        second = cache.stitched_density_start(net, 4, dt)
        assert np.array_equal(cache.stitched_density_finish(first, dt), want)
        assert np.array_equal(cache.stitched_density_finish(second, dt), want)


@pytest.mark.cuda
def test_run_overlapped_with_a_side_stream_on_the_producer():
    """The producer queues each result on a side stream behind a long spin
    kernel; the writer thread reads it through a Download, which waits on
    the event behind the copy, and sees the finished values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.eval.inference import run_overlapped
    from fcdgan_tpu_torch.utils.download import Download

    side = torch.cuda.Stream()
    base = torch.arange(1 << 20, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    seen = {}

    def compute(i):
        with torch.cuda.stream(side):
            torch.cuda._sleep(2_000_000)  # the result is late unless waited for
            return Download(base * (i + 1))

    def process(dl, i):
        seen[i] = dl.result().clone()

    run_overlapped(range(6), compute, process, depth=2)
    for i in range(6):
        assert torch.equal(seen[i], (base * (i + 1)).cpu())


def _uint16_scene(tmp_path):
    """A 3-band uint16 scene pair whose samples cover every value class of
    the type (0, 1, 32767, 32768 and up to 65535) and a uint8 reference."""
    from fcdgan_tpu_torch.data.tiff import TiffWriter

    rng = np.random.default_rng(4)
    paths = {}
    for name, shape in (("x", (90, 100, 3)), ("y", (90, 100, 3)), ("ref", (90, 100, 1))):
        if name == "ref":
            a = rng.integers(0, 2, size=shape).astype(np.uint8)
        else:
            a = rng.integers(0, 65536, size=shape).astype(np.uint16)
            a[:2, :5] = np.array([0, 1, 32767, 32768, 65535], np.uint16)[None, :, None]
        paths[name] = str(tmp_path / f"{name}.tif")
        with TiffWriter(paths[name], shape[1], shape[0], shape[2], a.dtype) as w:
            w.write_block(a)
    return paths


def _window_pair(tmp_path, device):
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneWindowCache
    from fcdgan_tpu_torch.data.normalize import Normalize

    p = _uint16_scene(tmp_path)
    norm = Normalize([30000.0, 32000.5, 31000.0], [18000.0, 17500.0, 19000.0],
                     [33000.0, 32500.0, 31500.0], [18500.0, 18250.0, 17000.0])
    ds = ScenePairDataset(p["x"], p["y"], ref_path=p["ref"], enhance=norm,
                          patch_size=(40, 40), overlap_padding=(4, 4))
    return ds, DeviceSceneWindowCache(ds, norm, device)


@pytest.mark.cuda
def test_uint16_raw_tiles_and_slabs_widen_on_the_card(tmp_path, monkeypatch):
    """uint16 slabs gathered on the card (through the int16 view) and raw
    uint16 tiles normalized there by DeviceNormalizer: the window tiles equal
    the CPU's bit for bit, the raw feed is within 1 ulp of the host
    normalization, and every value class widens to its own float."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.data.pipeline import (BatchLoader, DeviceNormalizer,
                                                NativeSceneBatchLoader, device_put_batch)

    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.3")
    ds, gpu = _window_pair(tmp_path, "cuda")
    _, cpu = _window_pair(tmp_path, "cpu")
    assert gpu.n_slabs >= 3
    for batch in gpu.loader(5, shuffle=True, seed=1):
        got, want = gpu.complete(batch), cpu.complete(batch)
        for k in ("x", "y", "ref"):
            assert torch.equal(got[k].cpu(), want[k]), k
    vals = torch.tensor([0, 1, 32767, 32768, 65535], dtype=torch.uint16)
    assert vals.cuda().float().cpu().tolist() == [0.0, 1.0, 32767.0, 32768.0, 65535.0]
    placer = DeviceNormalizer(ds.enhance, 3, "cuda")
    raw = NativeSceneBatchLoader(ds, 4, device_normalize=True)
    for rb, hb in zip(raw, BatchLoader(ds, 4, fields=("x", "y", "item", "ref"), tail="pad")):
        assert rb["x"].dtype == np.uint16
        db = placer(device_put_batch(rb, "cuda"))
        for k in ("x", "y"):
            np.testing.assert_array_max_ulp(db[k].cpu().numpy(), hb[k], maxulp=1)
        assert np.array_equal(db["ref"].cpu().numpy(), hb["ref"])


@pytest.mark.cuda
def test_slab_upload_behind_a_spin_is_read_right(tmp_path, monkeypatch):
    """Each slab's upload is queued on the cache's side stream behind a 2 ms
    spin: the gathers on the compute stream wait on its event and read the
    finished slab, batch after batch, slab switch after slab switch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.3")
    _, gpu = _window_pair(tmp_path, "cuda")
    _, cpu = _window_pair(tmp_path, "cpu")
    load = gpu._load_slab

    def late_load(k):
        with torch.cuda.stream(gpu._stream):
            torch.cuda._sleep(2_000_000)
        return load(k)

    gpu._load_slab = late_load
    for _ in range(2):
        for batch in gpu.loader(3, shuffle=True, seed=2):
            got = gpu.complete(batch)
            want = cpu.complete(batch)
            assert torch.equal(got["x"].cpu(), want["x"])
            assert torch.equal(got["ref"].cpu(), want["ref"])


@pytest.mark.cuda
@pytest.mark.parametrize("env", [{}, {"FCDGAN_SERVE_CANVAS_MAX_MB": "0.001"}],
                         ids=["canvas_overlap", "slabs"])
def test_window_density_on_the_card_is_the_resident_one(tmp_path, monkeypatch, env):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneWindowCache

    monkeypatch.delenv("FCDGAN_SERVE_BS", raising=False)
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd

    cache, net = _served_scene(tmp_path, "cuda")
    want = cache.stitched_density(net, 4)
    d = str(tmp_path)  # the scene and the stats caches that _served_scene wrote
    scaler = Normalize(*dataset_meanstd(os.path.join(d, "T1_stats.txt"),
                                        os.path.join(d, "T2_stats.txt"), None))
    ds = ScenePairDataset(os.path.join(d, "T1.tif"), os.path.join(d, "T2.tif"),
                          enhance=scaler, patch_size=(64, 64), overlap_padding=(6, 6))
    monkeypatch.setenv("FCDGAN_SCENE_WINDOW_MB", "0.45")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    win = DeviceSceneWindowCache(ds, scaler, "cuda")
    assert win.n_slabs >= 2
    assert np.array_equal(win.stitched_density(net, 4), want)
