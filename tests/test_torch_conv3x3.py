"""The port's 3x3 conv: plain version against the JAX Pallas kernel, the
wrapper's checks, its choice of kernel and the tensor-core kernel's weight
image, arithmetic and stage ring, modelled in numpy and Python. The CUDA
kernels' own tests are in tests/test_torch_cuda.py."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fcdgan_tpu.ops.pallas.conv3x3 import conv3x3_pallas_interpret
from fcdgan_tpu_torch.ops.conv3x3 import (MAX_C_IN, MAX_C_OUT, conv3x3, conv3x3_plain, gate,
                                          pack_wgmma_weight, variant, wgmma_plan,
                                          wgmma_weight_image)


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


def test_variant_is_a_function_of_dtype_and_channels():
    """bf16 -> the tensor-core kernel, f32 -> the CUDA-core kernel, for every
    gated (C_in, C_out); nothing else is taken."""
    for c_in in range(1, MAX_C_IN + 1):
        for c_out in range(1, MAX_C_OUT + 1):
            assert variant(torch.bfloat16, c_in, c_out) == "wgmma"
            assert variant(torch.float32, c_in, c_out) == "fma_f32"
    for dtype, c_in, c_out in [(torch.bfloat16, 65, 64), (torch.float32, 64, 129),
                               (torch.bfloat16, 0, 64)]:
        with pytest.raises(ValueError):
            variant(dtype, c_in, c_out)
    with pytest.raises(TypeError):
        variant(torch.float16, 64, 64)


def test_wgmma_plan_covers_every_gated_shape():
    """TMA per tap where the pixel stride is a multiple of 16 bytes, the
    im2col gather elsewhere; the K blocks cover K and the N tile C_out."""
    for c_in in range(1, MAX_C_IN + 1):
        for c_out in range(1, MAX_C_OUT + 1):
            plan = wgmma_plan(c_in, c_out)
            assert plan.nt in (64, 128) and c_out <= plan.nt
            assert plan.nt == 64 or c_out > 64
            assert plan.gather == (c_in % 8 != 0)
            if plan.gather:
                assert 64 * (plan.n_kb - 1) < 9 * c_in <= 64 * plan.n_kb <= 9 * 64
            else:
                assert plan.n_kb == 9
    assert wgmma_plan(3, 64) == (64, True, 1)  # inc.conv1: K = 27 in one block
    assert wgmma_plan(64, 128) == (128, False, 9)


def _weight_image_model(k, plan):
    """The kernel's shared-memory weight image, element by element: block b,
    row n, logical K column c stored at 16-byte group (c // 8) ^ (n % 8)."""
    c_in, c_out = k.shape[2], k.shape[3]
    img = np.zeros((plan.n_kb, plan.nt, 64), np.float32)
    for b in range(plan.n_kb):
        for n in range(c_out):
            for c in range(64):
                if plan.gather:
                    flat = 64 * b + c
                    if flat >= 9 * c_in:
                        continue
                    tap, ci = divmod(flat, c_in)
                else:
                    tap, ci = b, c
                    if ci >= c_in:
                        continue
                pos = ((c // 8) ^ (n % 8)) * 8 + c % 8
                img[b, n, pos] = k[tap // 3, tap % 3, ci, n]
    return img


WGMMA_SHAPES = [(3, 64), (64, 64), (64, 128), (8, 16), (5, 24), (63, 128), (40, 33), (1, 1)]


@pytest.mark.parametrize("c_in,c_out", WGMMA_SHAPES)
def test_wgmma_weight_image_matches_numpy_model(c_in, c_out):
    _, k = _inputs((1, 8, 8, c_in, c_out), seed=5)
    got = pack_wgmma_weight(torch.from_numpy(k)).numpy()
    assert got.shape == (wgmma_plan(c_in, c_out).n_kb, wgmma_plan(c_in, c_out).nt, 64)
    np.testing.assert_array_equal(got, _weight_image_model(k, wgmma_plan(c_in, c_out)))


def _swizzled(rows, phase):
    """Rows of 64 bf16 as a 128-byte-swizzled buffer stores them: row q's
    16-byte group j at position j ^ phase[q]."""
    out = np.empty_like(rows)
    pos = ((np.arange(64) // 8) ^ phase[:, None]) * 8 + np.arange(64) % 8
    out[np.arange(len(rows))[:, None], pos] = rows
    return out


def _read(buf, rows, phase):
    """The K columns of buffer rows ``rows`` as wgmma reads them, each row
    unswizzled by the phase of its address ((byte address >> 7) & 7)."""
    c = np.arange(64)[None, :]
    return buf[rows[:, None], ((c // 8) ^ phase[:, None]) * 8 + c % 8]


def _wgmma_kernel_model(x, img, plan, c_out):
    """The wgmma kernel's addressing and arithmetic in numpy, per 8x8-pixel
    tile. TMA: one stage holds the haloed 10x10 box (channels zero-filled to
    64, zero outside the image), pixel q in row q of 128 B; the A rows of tap
    (dy, dx) for output (r, c) are box rows (r+dy)*10 + c + dx. Gather: one
    stage per 64-wide block of the flat im2col K, row p = pixel p. The
    weight image's row n is read with phase n % 8."""
    n, h, w, c_in = x.shape
    xp = np.zeros((n, h + 10, w + 10, c_in), np.float32)  # zero border for the boxes
    xp[:, 1:h + 1, 1:w + 1] = x
    out = np.zeros((n, h, w, c_out), np.float32)
    r, c = np.divmod(np.arange(64), 8)  # output pixel m -> tile row, column
    hy, hx = np.divmod(np.arange(100), 10)  # box pixel q -> box row, column
    b_rows = np.arange(plan.nt)
    for b in range(n):
        for y0 in range(0, h, 8):
            for x0 in range(0, w, 8):
                acc = np.zeros((64, plan.nt), np.float32)
                if not plan.gather:
                    box = np.zeros((100, 64), np.float32)
                    box[:, :c_in] = xp[b, y0 + hy, x0 + hx]
                    stage = _swizzled(box, np.arange(100) % 8)
                    for tap in range(9):
                        q = (r + tap // 3) * 10 + c + tap % 3
                        acc += _read(stage, q, q % 8) @ _read(img[tap], b_rows, b_rows % 8).T
                else:
                    for kb in range(plan.n_kb):
                        a = np.zeros((64, 64), np.float32)
                        for k in range(64):
                            if 64 * kb + k < 9 * c_in:
                                tap, ci = divmod(64 * kb + k, c_in)
                                a[:, k] = xp[b, y0 + r + tap // 3, x0 + c + tap % 3, ci]
                        stage = _swizzled(a, np.arange(64) % 8)
                        rows = np.arange(64)
                        acc += _read(stage, rows, rows % 8) @ _read(img[kb], b_rows,
                                                                     b_rows % 8).T
                keep = (y0 + r < h) & (x0 + c < w)
                out[b, y0 + r[keep], x0 + c[keep]] = acc[keep, :c_out]
    return out


@pytest.mark.parametrize("shape", [(2, 11, 19, 3, 24), (1, 9, 17, 8, 64), (1, 10, 18, 64, 128),
                                   (1, 8, 9, 5, 7)])
def test_wgmma_kernel_model_matches_plain(shape):
    x, k = _inputs(shape, seed=6)
    img = pack_wgmma_weight(torch.from_numpy(k)).numpy()
    got = _wgmma_kernel_model(x, img, wgmma_plan(shape[3], shape[4]), shape[4])
    want = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-5)


def test_wgmma_weight_image_is_kept_until_the_weight_changes():
    """Packed once per weight tensor and version: the same image for an
    unchanged weight, a new one after an in-place update, none shared with
    another tensor of equal values."""
    _, k = _inputs((1, 8, 8, 64, 64), seed=7)
    w = torch.from_numpy(k).to(torch.bfloat16)
    first = wgmma_weight_image(w)
    assert wgmma_weight_image(w) is first
    np.testing.assert_array_equal(first.float().numpy(), pack_wgmma_weight(w).float().numpy())
    twin = w.clone()
    assert wgmma_weight_image(twin) is not first
    with torch.no_grad():
        w.mul_(2)
    second = wgmma_weight_image(w)
    assert second is not first
    np.testing.assert_array_equal(second.float().numpy(), 2 * first.float().numpy())
    with torch.inference_mode():  # no version counter: packed on every call
        frozen = w.clone()
    np.testing.assert_array_equal(wgmma_weight_image(frozen).float().numpy(),
                                  second.float().numpy())


def _ring_slot(i, l, loads):
    """(stage, parity) of load l of a block's i-th tile: ``ring_slot`` of
    csrc/conv3x3.cu, one ring of 2 stages per consumer warpgroup."""
    j = (i // 2) * loads + l
    return 2 * (i % 2) + j % 2, (j // 2) & 1


def _shared_ring_slot(i, l, loads):
    """One ring of 4 stages for both warpgroups: its parity waits alias once
    a tile takes 4 or more loads."""
    g = i * loads + l
    return g % 4, (g // 4) & 1


def _ring_model_holds(slot, n_tiles, loads, seed):
    """The wgmma kernel's producer and two consumer warpgroups (tile i to
    warpgroup i % 2) on 4 stages with full and empty mbarriers, in a random
    interleaving with loads that land late. A barrier counts its completed
    phases, and a wait on parity P returns once that count's parity differs
    from P (PTX's try_wait.parity). False if a consumer's wait returns before
    its own load is in the stage, if the producer reuses a stage that is
    still held, or if the agents deadlock."""
    rng = random.Random(seed)
    full, empty, state = [0] * 4, [0] * 4, ["free"] * 4
    landing = []  # (stage, tag) of issued loads that have not landed

    def producer():
        for i in range(n_tiles):
            for l in range(loads):
                stage, parity = slot(i, l, loads)
                yield empty, stage, parity ^ 1
                if state[stage] != "free":
                    raise AssertionError
                state[stage] = "writing"
                landing.append((stage, (i, l)))

    def consumer(wg):
        for i in range(wg, n_tiles, 2):
            for l in range(loads):
                stage, parity = slot(i, l, loads)
                yield full, stage, parity
                if state[stage] != ("ready", (i, l)):
                    raise AssertionError
                state[stage] = "reading"
                yield None  # the wgmma chain runs
                state[stage] = "free"
                empty[stage] += 1

    agents = {name: [gen, next(gen, StopIteration)] for name, gen in
              (("producer", producer()), ("wg0", consumer(0)), ("wg1", consumer(1)))}
    agents = {name: agent for name, agent in agents.items() if agent[1] is not StopIteration}
    try:
        while agents or landing:
            ready = [name for name, (_, wait) in agents.items()
                     if wait is None or wait[0][wait[1]] % 2 != wait[2]]
            choices = ready + (["land"] if landing else [])
            if not choices:
                return False  # deadlock
            pick = rng.choice(choices)
            if pick == "land":
                stage, tag = landing.pop(rng.randrange(len(landing)))
                state[stage] = ("ready", tag)
                full[stage] += 1
                continue
            gen = agents[pick][0]
            agents[pick][1] = nxt = next(gen, StopIteration)
            if nxt is StopIteration:
                del agents[pick]
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("loads", [1, 2, 3, 4, 5, 9])
def test_wgmma_stage_ring_waits_are_valid(loads):
    """Every parity wait of the kernel's schedule names its own load, for
    the TMA loader (1 load a tile) and every gather depth (1-9 K blocks),
    over many interleavings; the same model finds the shared ring's fault."""
    assert all(_ring_model_holds(_ring_slot, n_tiles, loads, seed)
               for n_tiles in (1, 2, 5, 8) for seed in range(40))
    if loads >= 4:
        assert not all(_ring_model_holds(_shared_ring_slot, 8, loads, seed)
                       for seed in range(40))
