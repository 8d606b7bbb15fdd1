#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

  device   the card's name and power limit (nvidia-smi)
  build    nvcc builds every kernel source of the port (all started together)
  kernels  each kernel at the shapes its main path gives it, against its
           plain version on the card, with the median device ms of the
           kernel, of the plain version and of the one library call that
           computes the same function (timed here only; null where there is
           none), each from back-to-back calls queued behind a spin kernel;
           call_ms, one kernel call from an idle card with the wrapper's host
           work; the bound and what bounds it:
             conv3x3    bf16 (the wgmma kernel): the three gated convs of
                        one serving chunk (patch 220, batch 10 stacked to
                        20; also S's convs in a USSS joint step), G's trunk
                        in a USSS joint step, a WSSS adversarial step and a
                        WSSS G-pretrain step, S's three in a WSSS step, each
                        with its count per step and one wgmma launch; f32
                        (the CUDA-core kernel of the parity paths) at inc
                        conv2; library F.conv2d; the 3-band rows also time
                        the layer with its input zero-padded to 8 channels,
                        pad included, which TMA takes (channel_pad_tma_ms)
             pool_bwd   the 8 max-pool backwards of one USSS step (the
                        Segmentor's 4 at N=20, the per-band VGG's 4 at
                        N=60) and of the RSSS steps (S's 4 at N=24, the
                        4-band VGG's at N=96 in an adversarial step and 80
                        in a G-pretrain step), bf16 and f32, bit-equal;
                        library aten.max_pool2d_with_indices_backward
             fused_ssim the 5 MS-SSIM levels of one USSS step (N=10, 3
                        bands) and of an RSSS adversarial step (N=12, 4
                        bands, 200 to 13 px), f32, atol 2e-5; each row with
                        its tile and tiles
             channel_sums, channel_sums_pair  every distinct BN input of one
                        USSS joint step (batch 10, bf16), the
                        Discriminator's three of a WSSS step, and those of
                        an RSSS G-pretrain step (G at N=20) and adversarial
                        step (S at N=24, D's three at N=24), each with its
                        count per step, recorded from train-mode forwards of
                        the models; within 1e-5 of the sum of magnitudes per
                        channel; library torch.var_mean and
                        torch.batch_norm_backward_reduce; each row with its
                        blocks per launch
           and for these three: exactly one device launch per call (the
           kernels, copies and fills a torch.profiler trace of three warm
           calls shows, the same kernel once a call) and three calls bitwise
           equal
             phase_pool every max-pool forward of a USSS joint step and of
                        the two RSSS steps (recorded the same way), bf16 and
                        f32, bit-equal to its plain version and to
                        F.max_pool2d
  serve    tools.infer.main on a 2048x2048 3-band uint16 scene with a seeded
           full-width Segmentor (bf16), the fused resident path at main()'s
           chunk width (FCDGAN_SERVE_BS=32 unless set): output rasters,
           density in [0, 1], finite oa/f1, conv3x3 launched 3 times and
           phase_pool 4 times per chunk of the plan that serve_chunks gives
           (the other kernels not at all), every conv3x3 launch on the wgmma
           variant; px_per_s
  serve_bs the same scene through tools.infer.run at FCDGAN_SERVE_BS 0 and
           32, in turns, twice each: densities within one bf16 step of the
           density (2^-8) and the share of pixels that moved, each run's
           launches from its chunk plan; px_per_s of each
  serve_stream  the same scene on the streaming path (host tiles, pinned
           uploads, a writer thread), downloads in float32 and uint8, twice
           each: within 1e-3 (uint8: 1/510 + 1e-3) of the fused batch-exact
           density, 3 conv3x3 (all wgmma) and 4 phase_pool launches a batch;
           px_per_s
  parity   one chunk of 2 tiles through the port in f32 on the card and on
           the CPU (plain versions): max abs density difference <= 1e-3
  train    demos.demo_usss.main on a 1024x1024 3-band uint16 scene (patch
           220, padding 10, batch 10: 36 tiles, 4 steps per epoch), bf16,
           1 G-pretrain + 1 S-init + 3 joint epochs (20 steps), then the
           fused stitched inference: every artifact, finite losses and
           metrics, density in [0, 1], SModel loading strictly, each
           kernel's launches equal to the count derived from the models and
           every conv3x3 launch on the wgmma variant;
           seconds per phase, joint epochs/s over the warm epochs 2-3, tile
           Mpx/s, peak device memory
  train_parity  one joint step on 2 tiles in f32 from the same seeded
           weights on the card and on the CPU: losses (rtol 1e-4), each
           net's global gradient norm (rtol 1e-3), BN running stats (atol
           1e-4), and the step's own 5 MS-SSIM levels before the relu: the
           kernel against the plain version on the card's level inputs (atol
           2e-5), the card's (ssim, cs) tables against the CPU's (atol 1e-4)
  wsss     demos.demo_wsss.main on a synthetic WHU set of 150 changed and
           150 unchanged 200x200 RGB uint8 slices (the JAX package's
           production settings: batch 15, unc batch 50, bf16, RGB perception
           at layer 1), 1 G-pretrain + 3 adversarial epochs, then the
           train-mode inference over the 150 changed slices: every artifact,
           finite losses and metrics, strict loads, each kernel's launches
           equal to the count derived from the models and every conv3x3
           launch on the wgmma variant; seconds per
           phase, adversarial epochs/s over the warm epochs 2-3, slice Mpx/s,
           peak device memory
  wsss_parity  one adversarial step on 2 pairs in f32 from the same seeded
           weights on the card and on the CPU: losses (rtol 1e-4), S and D
           gradient norms (rtol 1e-3), BN running stats of S and D (atol
           1e-4), and the BN kernels against the plain sums on the step's own
           BN inputs (1e-5 of the sum of magnitudes)
  serve_whu  tools.infer --mode whu over the wsss phase's 150 changed slices
           with its SModel, batch 15: bn_mode train (S's BN statistics per
           batch, one channel_sums launch per BN and batch) with the density
           images within one grey level of the demo's own train-mode
           inference (byte-equality reported), then bn_mode eval; finite
           metrics, launches from the batches; slices/s of each
  rsss     demos.demo_rsss.main on a synthetic OSCD layout: train scenes
           alpha and beta, test scene gamma, each 1024x1024 with 4 uint16
           bands (Sentinel-2 L1C's type), change rectangles across the scene
           and regions grown around them (36 tiles a scene at patch 200,
           padding 10), bf16, the default batches 20 and 12, 1 G-pretrain +
           3 adversarial epochs, each followed by the train-mode-BN test
           evaluation, then the eval-mode inference into a density and a
           color raster per test scene: every artifact, density in [0, 1],
           the color raster's shape and codes, finite losses and metrics,
           strict 4-band loads, the test confusions covering the test
           scene's interiors exactly, each kernel's launches equal to the
           count derived from the models and every conv3x3 launch on the
           wgmma variant; seconds per phase, adversarial epochs/s over the
           warm epochs 2-3, tile Mpx/s, peak device memory
  rsss_parity  one adversarial step on 2 tiles and then one train-mode test
           evaluation batch, f32, from the same seeded weights on the card
           and on the CPU: losses (l1_loss and r_loss included, rtol 1e-4),
           S and D gradient norms (rtol 1e-3), S and D BN running stats after
           both calls (atol 1e-4), the BN kernels against the plain sums on
           the calls' own BN inputs, and the step's 5 MS-SSIM levels at C = 4,
           kernel against plain version (atol 2e-5)

  serve_oscd  tools.infer --mode oscd over all three scenes of the rsss
           phase with its SModel, bf16, batch 12 at FCDGAN_SERVE_BS=0 (the
           demo's own inference chunks), the fused path with two scenes in
           flight, twice: a density and a color raster per scene, the test
           scene's density within 1e-3 of the demo's (bit-equality reported),
           finite oa/kappa/auc, launches from the chunk plan; px_per_s

The training options, each run's launches held against the count derived
for it (``<phase>_launches`` in the kernels line), every bf16 conv3x3 on
wgmma:
  usss_split  the train phase's USSS run with --siamese-stats split (S's
           encoder once per branch), 1 + 1 + 1 epochs; its joint epoch
           rate beside the train phase's; usss_split_parity: the
           train_parity step with split S
  remat    USSS joint steps at batch 10 with and without remat from the
           same weights: BN buffers and counts after one step (f32 1e-6,
           bf16 1e-4) and losses; step ms and peak memory of each, in turns
  resume   the train phase's scene with --checkpoint-every 1 stopped after
           the S init, then --resume: completed phases skipped, the restored
           state_dicts and Adam states bit-equal to the files; seconds a save
  replay   the USSS joint step (batch 10 and a 1-tile tail) and the WSSS
           adversarial step (15 pairs) as CUDA graphs: each shape's first
           call counted twice by the kernel wrappers (its eager step and its
           capture), then three replays under torch.profiler, each launching
           every kernel as often as the step's derived count says, none of
           them counted on the host
  profile  a USSS run under --profile-dir: the trace holds a CUDA event of
           each kernel it launched, by symbol
  wsss_split  one adversarial epoch of the wsss phase's set with split S
           and D; wsss_split_parity (74 BN passes a step), serve_whu_split
           (train-mode BN, split) against the demo's densities
  eraser   one adversarial epoch each of WSSS and RSSS with --random-eraser
           on the Python loaders (feed host), beside the resident rate

Data parallel (``parallel.mesh``), each run's launches held against the
count derived for it:
  serve_dp  tools.infer --n-devices 1 on the 2048² scene: a world of one
           (NCCL), the streaming path with each batch split over the ranks
           and gathered, within 1e-3 of the fused batch-exact density; 3
           conv3x3 and 4 phase_pool launches a batch; px_per_s
  dp_world1  the train phase's run with --n-devices 1 (NCCL, the padded
           tail, every all-reduce) and with --tail pad without a process
           group, twice each in turns: densities and each epoch's losses of
           the two kinds within two bf16 steps and 1.5e-2 relative, or twice
           the gap between two runs of one kind when larger (bf16 training
           on the card is not bitwise repeatable), launches; joint epochs/s
           of each; profile_train's
           USSS joint step in the world of one and without a group: the
           all-reduce calls and their device ms per step
  dp_two_ranks  two ranks share the card over gloo (NCCL takes one rank per
           device; the line before it names the backend): one USSS joint and
           one WSSS adversarial step at full width in f32 on padded global
           batches against the single-process step: losses (rtol 1e-4),
           each net's gradient norm (rtol 1e-3), BN running stats (atol
           1e-4), confusion equal, parameters as in the CPU tests; both
           ranks' states bit-equal; the CPU tests' tighter measures reported

The benchmark entry and the optimizer layouts:
  bench    every mode of ``fcdgan_tpu_torch.tools.bench`` once at the JAX
           bench's defaults, in this process, its JSON lines printed: the
           default mode, --driver, --inference (float32 and uint8),
           --pretrain, --wsss, --rsss, --wsss-driver, --rsss-driver,
           --batch-sweep and --scaling (n = 1 on the card, the JAX error row
           past the card count): each line's metric, unit and positive value,
           the 36 tiles of the USSS scene, 64 collective calls a scaling
           step; each kernel's launches in the default mode and the three
           driver modes equal to the count derived for the steps they ran,
           every bf16 conv3x3 on wgmma; the six kernels in every training
           mode, conv3x3 and phase_pool alone in --inference; seconds a mode
  opt_layouts  FCDGAN_OPT=flat and grouped: one USSS joint step and one
           WSSS adversarial step each (finite metrics, every stepped net
           moved), and each layout's update from the leaf step's gradients
           and initial parameters against the leaf step's parameters (rtol
           1e-6, atol 1e-7)

Then one JSON line of kernel records (conv3x3's sums one serving chunk;
the JSON summary file adds its ms per training step), and as the last line
{"ok": true, "device": {...}}. f32 comparisons run with TF32 off (cuDNN and
cuBLAS), set once for the whole script. The scratch files go to
chiprun_out/chip_smoke/ inside the checkout and are removed at the end.
"""

import collections
import contextlib
import functools
import gc
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor cores, f32 on
# the CUDA cores, device memory bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
SERVE_SHAPES = [  # (layer, N, H, W, C_in, C_out) of one serving chunk
    ("inc.conv1", 20, 220, 220, 3, 64),
    ("inc.conv2", 20, 220, 220, 64, 64),
    ("down1.conv1", 20, 110, 110, 64, 128),
]
# (layer, step, count per step, N, H, W, C_in, C_out) of the training paths'
# conv3x3 launches besides the serving shapes (which are also S's convs in a
# USSS joint step): G's 11 trunk convs per USSS joint step, WSSS adversarial
# step (G eval forward on 15 slices) and WSSS G-pretrain step (unc batch 50),
# and S's three per forward at N = 2 x 15 in a WSSS adversarial step (two S
# forwards per step)
TRAIN_CONV_SHAPES = [
    ("G trunk", "usss_joint", 11, 10, 220, 220, 64, 64),
    ("G trunk", "wsss_adversarial", 11, 15, 200, 200, 64, 64),
    ("G trunk", "wsss_g_pretrain", 11, 50, 200, 200, 64, 64),
    ("S inc.conv1", "wsss_adversarial", 2, 30, 200, 200, 3, 64),
    ("S inc.conv2", "wsss_adversarial", 2, 30, 200, 200, 64, 64),
    ("S down1.conv1", "wsss_adversarial", 2, 30, 100, 100, 64, 128),
    ("S inc.conv1", "rsss_adversarial", 1, 24, 200, 200, 4, 64),
    ("S inc.conv2", "rsss_adversarial", 1, 24, 200, 200, 64, 64),
    ("S down1.conv1", "rsss_adversarial", 1, 24, 100, 100, 64, 128),
    ("G trunk", "rsss_adversarial", 11, 12, 200, 200, 64, 64),
    ("G trunk", "rsss_g_pretrain", 11, 20, 200, 200, 64, 64),
]
# (pool, step, N, H, W, C) of the max-pool backwards of one step: in a USSS
# S-init or joint step the Segmentor's Down pools on the stacked pair (2 x
# batch 10), then the per-band VGG's on the stacked [target; generated]
# planes (2 x 3 bands x batch 10); in an RSSS adversarial step S's at 2 x 12
# and the 4-band VGG's at 2 x 4 x 12; in an RSSS G-pretrain step the VGG's
# on the generated planes only (4 x 20)
POOL_SHAPES = [(f"{net}.pool{i + 1}", step, n, side >> i, side >> i, c)
               for net, step, n, side in (("S", "usss_joint", 20, 220),
                                          ("VGG", "usss_joint", 60, 220),
                                          ("S", "rsss_adversarial", 24, 200),
                                          ("VGG", "rsss_adversarial", 96, 200),
                                          ("VGG", "rsss_g_pretrain", 80, 200))
               for i, c in enumerate((64, 128, 256, 512))]
# (step, N, H, W, C) of the MS-SSIM levels: a USSS step's (N = 10, 3 bands)
# and an RSSS adversarial step's (N = 12, 4 bands)
SSIM_SHAPES = ([("usss_joint", 10, hw, hw, 3) for hw in (220, 110, 55, 28, 14)]
               + [("rsss_adversarial", 12, hw, hw, 4) for hw in (200, 100, 50, 25, 13)])
SCENE = 2048
TRAIN_SCENE = 1024
BATCH = 10
PATCH = 220
PAD = 10
TRAIN_EPOCHS = (1, 1, 3)  # G pretrain, S init, joint
WSSS_SLICES = (150, 150)  # changed, unchanged
WSSS_SIZE = 200
WSSS_BATCH = 15
WSSS_UNC_BATCH = 50
WSSS_EPOCHS = (1, 3)  # G pretrain, adversarial
RSSS_SCENE = 1024  # px, the side of each synthetic OSCD scene
RSSS_BANDS = 4
RSSS_SCENES = (("alpha", "beta"), ("gamma",))  # train, test
RSSS_PATCH = 200
RSSS_INIT_BATCH = 20
RSSS_BATCH = 12
RSSS_EPOCHS = (1, 3)  # G pretrain, adversarial
# the rolling-window budget of the 2048² scene's phases: 3 tile rows a slab,
# 4 slabs (the packed uint16 slab is 620 x 2220 x 7 x 2 bytes, 3 slots)
WINDOW_MB = "64"
SERVE_REPEATS = 3  # windowed serving: each path timed this often in turn
SOURCES = ["conv3x3", "pool_bwd", "fused_ssim", "channel_sums", "phase_pool"]
# S computes in bf16 and its density is bf16-valued: one step is 2^-8 on
# [0.5, 1), the largest below 1. Two chunk widths give cuDNN other batches
# (other algorithms), so their densities may differ by that step
BF16_STEP = 2.0 ** -8
# dp_world1's floors: densities within two bf16 steps, losses within 1.5e-2
# relative, twice the largest gaps between two runs of the same kind seen on
# the H100 (one bf16 step; 6.9e-3 in an epoch's loss): no repeat is bitwise
DP_WORLD1_FLOORS = (2 * BF16_STEP, 1.5e-2)


def phase(name, payload):
    print(name, json.dumps(payload), flush=True)


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    torch.cuda._sleep(1_000_000)  # first launch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def cuda_ms(torch, fn, reps=10, warmup=3):
    """Median device time of one call of ``fn`` in ms. CUDA events enclose
    ``inner`` back-to-back calls (as many as take about 2 ms, at most 50),
    queued behind a spin kernel that outlasts the host's work of queueing
    them, so that the events see the card's time and not the wrapper's host
    work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    inner = max(1, min(50, int(2.0 / max(start.elapsed_time(end), 1e-3))))
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int((2 * host_ms + 0.5) * spin_cycles_per_ms(torch))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def call_ms(torch, fn, reps=20):
    """Median time of one call of ``fn`` in ms from an idle card, host work
    included (CUDA events around the single call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_launches(torch, fn, calls=3, traces=3):
    """The kernels, copies and fills that ``calls`` warm calls of ``fn`` put
    on the card, by name, from a torch.profiler trace (not the wrappers'
    counters): one list per call, cut in order. A trace with no device event
    at all is a dropped trace, not a count (the calls' results are checked
    elsewhere), and is taken again, at most ``traces`` times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in sorted(prof.events(), key=lambda ev: ev.time_range.start)
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False)]
        if names:
            break
    per = max(-(-len(names) // calls), 1)  # every trace dropped: no names at all
    return [names[i:i + per] for i in range(0, len(names), per)] or [[]] * calls


def one_launch_each(launched):
    """Whether every call's list is the same single kernel."""
    return all(len(c) == 1 and c == launched[0] for c in launched)


def repeatable(torch, fn, calls=3):
    """Whether ``calls`` calls of ``fn`` give bitwise equal tensors."""
    outs = [[t.clone() for t in fn()] for _ in range(calls)]
    return all(torch.equal(a, b) for other in outs[1:] for a, b in zip(outs[0], other))


def device_phase():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", {"nvidia_smi": smi})
    return smi


def build_phase():
    """nvcc for every kernel source and g++ for the native tile I/O library,
    all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from fcdgan_tpu_torch import native
    from fcdgan_tpu_torch.ops import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(build.host_library, native.SOURCE)
        logs = build.build(SOURCES)
        host.result()
    native.load()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    phase("build", {"seconds": time.perf_counter() - t0, "ptxas": ptxas,
                    "native": os.path.basename(build.host_library(native.SOURCE))})


def roofline(nbytes, flops, dtype_name):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def conv_rows(torch, F):
    """conv3x3 at every shape of the main paths: the serving chunk's three
    (which are also S's convs in a USSS joint step) and the training shapes
    in bf16, each row with its count per step; one f32 row for the CUDA-core
    kernel of the parity paths."""
    from fcdgan_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, variant

    shapes = [(layer, "serve_chunk", 1, *shape, "bfloat16") for layer, *shape in SERVE_SHAPES]
    shapes += [(*row, "bfloat16") for row in TRAIN_CONV_SHAPES]
    shapes.append(("inc.conv2", "serve_chunk", 1, *SERVE_SHAPES[1][1:], "float32"))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for layer, step, count, n, h, w, ci, co, dtype_name in shapes:
        dt = getattr(torch, dtype_name)
        x = torch.randn((n, h, w, ci), generator=gen, device="cuda").to(dt)
        bound = 1.0 / math.sqrt(9 * ci)  # torch's default conv init range
        k = ((torch.rand((3, 3, ci, co), generator=gen, device="cuda") * 2 - 1)
             * bound).to(dt)
        kind = variant(dt, ci, co)
        before = conv3x3.launches_by_variant[kind]
        got = conv3x3(x, k)
        launched = conv3x3.launches_by_variant[kind] - before
        want = conv3x3_plain(x, k)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # f32: summation order only; bf16: one output rounding (1 ulp of
        # the largest value)
        tol = 2e-4 if dt == torch.float32 else 2.0 ** -7 * want.float().abs().max().item()
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
        k_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib = F.conv2d(x_nchw, k_oihw, padding=1)
        lib_err = (lib.permute(0, 2, 3, 1).float() - want.float()).abs().max().item()
        item = dt.itemsize
        nbytes = (x.numel() + k.numel() + got.numel()) * item
        flops = 2 * n * h * w * 9 * ci * co
        bound_ms, bound_by = roofline(nbytes, flops, dtype_name)
        pad_ms = None
        if kind == "wgmma" and ci % 8:
            # the alternative to the gather: channels zero-padded to a
            # multiple of 8 by the caller, so that TMA takes the layer
            pad = 8 - ci % 8
            k8 = F.pad(k, (0, 0, 0, pad))
            pad_err = (conv3x3(F.pad(x, (0, pad)), k8).float() - want.float()).abs().max().item()
            if not pad_err <= tol:
                raise AssertionError(f"conv3x3 {layer} {step} channel-padded: max abs err "
                                     f"{pad_err} (tol {tol})")
            pad_ms = cuda_ms(torch, lambda: conv3x3(F.pad(x, (0, pad)), k8))
        row = {
            "name": "conv3x3", "layer": layer, "step": step, "per_step": count,
            "variant": kind, "dtype": dtype_name, "shape": [n, h, w, ci, co],
            "max_abs_err": err, "tol": tol, "library_max_abs_err": lib_err,
            "ms": cuda_ms(torch, lambda: conv3x3(x, k)),
            "call_ms": call_ms(torch, lambda: conv3x3(x, k)),
            "plain_ms": cuda_ms(torch, lambda: conv3x3_plain(x, k), reps=3),
            "library_ms": cuda_ms(torch, lambda: F.conv2d(x_nchw, k_oihw, padding=1)),
            "channel_pad_tma_ms": pad_ms,
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        phase("kernels", row)
        if not (err <= tol and launched == 1):
            raise AssertionError(f"conv3x3 {layer} {step} {dtype_name}: max abs err {err} "
                                 f"(tol {tol}), {launched} {kind} launches")
        rows.append(row)
        del x, k, got, want, lib
    torch.cuda.empty_cache()
    return rows


def conv_per_step(rows):
    """conv3x3 device ms, bound ms and F.conv2d ms per training step (bf16):
    a USSS joint step runs G's trunk and S's three serving-shape convs; a
    WSSS or RSSS step its own rows."""
    out = {}
    for step, extra in (("usss_joint", "serve_chunk"), ("wsss_adversarial", None),
                        ("wsss_g_pretrain", None), ("rsss_adversarial", None),
                        ("rsss_g_pretrain", None)):
        sel = [r for r in rows if r["dtype"] == "bfloat16" and r["step"] in (step, extra)]
        out[step] = {key: sum(r["per_step"] * r[key] for r in sel)
                     for key in ("ms", "bound_ms", "library_ms", "plain_ms")}
        out[step]["launches"] = sum(r["per_step"] for r in sel)
    return out


def pool_rows(torch, F):
    """pool_bwd at the pools of each step, bf16 and f32: bit-equal to its
    plain version and to torch's own max-pool backward."""
    from fcdgan_tpu_torch.ops.pool_bwd import pool_bwd, pool_bwd_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for layer, step, n, h, w, c in POOL_SHAPES:
            # post-ReLU activations, as the pools see them: many tied zeros
            x = torch.relu(torch.randn((n, h, w, c), generator=gen, device="cuda")).to(dt)
            dy = torch.randn((n, h // 2, w // 2, c), generator=gen, device="cuda").to(dt)
            got = pool_bwd(x, dy)
            want = pool_bwd_plain(x, dy)
            x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            _, idx = F.max_pool2d(x_nchw, 2, return_indices=True)

            def library():
                return torch.ops.aten.max_pool2d_with_indices_backward(
                    dy_nchw, x_nchw, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)

            lib = library().permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.equal(got, want) and torch.equal(got, lib)
            # x and dy read once, dx written once; 7 compares/selects per
            # window and channel
            nbytes = (2 * x.numel() + dy.numel()) * dt.itemsize
            bound_ms, bound_by = roofline(nbytes, 7 * dy.numel(), "float32")
            row = {"name": "pool_bwd", "layer": layer, "step": step, "dtype": dtype_name,
                   "shape": [n, h, w, c], "max_abs_err": err, "tol": 0.0,
                   "bit_equal_plain_and_library": ok,
                   "ms": cuda_ms(torch, lambda: pool_bwd(x, dy)),
                   "call_ms": call_ms(torch, lambda: pool_bwd(x, dy)),
                   "plain_ms": cuda_ms(torch, lambda: pool_bwd_plain(x, dy), reps=5),
                   "library_ms": cuda_ms(torch, library),
                   "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}
            phase("kernels", row)
            if not (ok and err == 0):
                raise AssertionError(f"pool_bwd {layer} {step} {dtype_name}: not bit-equal "
                                     f"(max abs err {err})")
            rows.append(row)
            del x, dy, got, want, lib, idx
    torch.cuda.empty_cache()
    return rows


def ssim_rows(torch):
    """fused_ssim at the 5 MS-SSIM levels of each step, f32, atol 2e-5."""
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level, ssim_level_plain, tile_plan

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    k = 11
    for step, n, h, w, c in SSIM_SHAPES:
        x = torch.rand((n, h, w, c), generator=gen, device="cuda")
        y = (x + 0.08 * torch.randn((n, h, w, c), generator=gen, device="cuda")).clamp(0, 1)
        got = ssim_level(x, y, 1.0)
        want = ssim_level_plain(x, y, 1.0)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        launched = device_launches(torch, lambda: ssim_level(x, y, 1.0))
        same = repeatable(torch, lambda: ssim_level(x, y, 1.0))
        plan = tile_plan(n, h, w, k, torch.cuda.get_device_properties(0).multi_processor_count)
        vh, vw = h - k + 1, w - k + 1
        # x and y read once, two (N, C) tables written; operations: the three
        # products per pixel, 5 maps x K taps of multiply-add along H over
        # VH x W and along W over VH x VW, and about 20 for the two maps
        nbytes = 2 * x.numel() * 4 + 2 * n * c * 4
        flops = n * c * (3 * h * w + 10 * k * vh * w + (10 * k + 20) * vh * vw)
        bound_ms, bound_by = roofline(nbytes, flops, "float32")
        row = {"name": "fused_ssim", "layer": f"level {h}x{w}", "step": step, "dtype": "float32",
               "shape": [n, h, w, c], "max_abs_err": err, "tol": 2e-5,
               "tile": [plan.th, plan.tw], "tiles": n * plan.tiles_y * plan.tiles_x,
               "device_launches_per_call": launched[0],
               "one_device_launch_each_of_3_calls": one_launch_each(launched),
               "bitwise_repeatable": same,
               "ms": cuda_ms(torch, lambda: ssim_level(x, y, 1.0)),
               "call_ms": call_ms(torch, lambda: ssim_level(x, y, 1.0)),
               "plain_ms": cuda_ms(torch, lambda: ssim_level_plain(x, y, 1.0), reps=5),
               "library_ms": None, "bytes": nbytes, "flops": flops,
               "bound_ms": bound_ms, "bound_by": bound_by}
        phase("kernels", row)
        if not (err <= 2e-5 and one_launch_each(launched) and same):
            raise AssertionError(f"fused_ssim {step} {h}x{w}x{c}: max abs err {err} (tol 2e-5), "
                                 f"device launches {launched}, repeatable {same}")
        rows.append(row)
    return rows


@contextlib.contextmanager
def record_calls(module, name, clone=False):
    """Within the block, every call of ``module.name`` is kept in the yielded
    list as (args, result); ``clone`` keeps copies of the tensor arguments.
    A call made while a CUDA graph is being captured computes nothing (a
    graphed step's first call captures after its eager step), so it is not
    kept."""
    import torch

    orig, calls = getattr(module, name), []

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return out
        kept = tuple(a.detach().clone() if clone and hasattr(a, "detach") else a
                     for a in args)
        calls.append((kept, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def step_shapes(torch):
    """The NHWC shapes of the BN inputs and max-pool inputs of one step of
    each training path, each with its count per step: a USSS joint step at
    batch 10 (G on 10 tiles, S on the stacked pair, the per-band VGG on the
    stacked [target; generated] planes), the Discriminator's BN inputs in a
    WSSS adversarial step (15 pairs stacked, 200 px, three D forwards), an
    RSSS G-pretrain step (G on 20 4-band tiles, the per-band VGG on the
    target and the generated planes, two passes) and an RSSS adversarial
    step (S and D on 12 stacked 4-band pairs, D three times, the VGG on the
    stacked planes). Recorded from train-mode forwards of the models on the
    card (their kernel launches are set-up and the main paths' counts start
    from 0 later)."""
    from fcdgan_tpu_torch.models import layers
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import (VGG16Weights, select_feature_layers,
                                             vgg16_features, vgg16_random_params)
    from fcdgan_tpu_torch.ops import pool_bwd as pool_mod

    bf16 = torch.bfloat16
    vgg = VGG16Weights(vgg16_random_params(0), "cuda")

    def nhwc(t):
        return (t.shape[0], t.shape[2], t.shape[3], t.shape[1])

    def recorded(*calls, times=1):
        """{shape: count} of the BN inputs and of the max-pool inputs that
        ``calls`` (thunks) make, each count times ``times``."""
        with record_calls(layers, "bn_train") as bns, \
                record_calls(pool_mod, "phase_pool") as pls:
            for call in calls:
                call()
        bn = collections.Counter(nhwc(args[0]) for args, _ in bns)
        pools = collections.Counter(tuple(args[0].shape) for args, _ in pls)
        return ({k: v * times for k, v in bn.items()}, {k: v * times for k, v in pools.items()})

    def tiles(n, c, side):
        return torch.zeros((n, c, side, side), device="cuda")

    def planes(n, side):
        return lambda: vgg16_features(torch.zeros((n, side, side, 1), device="cuda"), vgg,
                                      select_feature_layers(1), bf16)

    def net(cls, nband):
        return cls(nband, compute_dtype=bf16).cuda().train()

    steps = {}
    with torch.no_grad():
        u, r, b = tiles(BATCH, 3, PATCH), tiles(RSSS_BATCH, RSSS_BANDS, RSSS_PATCH), \
            tiles(RSSS_INIT_BATCH, RSSS_BANDS, RSSS_PATCH)
        sl = tiles(WSSS_BATCH, 3, WSSS_SIZE)
        g3, s3, d3 = net(Generator, 3), net(Segmentor, 3), net(Discriminator, 3)
        g4, s4, d4 = net(Generator, 4), net(Segmentor, 4), net(Discriminator, 4)
        steps["usss_joint"] = recorded(lambda: g3(u), lambda: s3(u, u),
                                       planes(2 * 3 * BATCH, PATCH))
        steps["wsss_adversarial"] = recorded(lambda: d3(sl, sl), times=3)  # 3 D forwards
        steps["rsss_g_pretrain"] = (recorded(lambda: g4(b))[0],  # the VGG: target, generated
                                    recorded(planes(RSSS_BANDS * RSSS_INIT_BATCH, RSSS_PATCH),
                                             times=2)[1])
        s_bn, s_pools = recorded(lambda: s4(r, r), planes(2 * RSSS_BANDS * RSSS_BATCH,
                                                          RSSS_PATCH))
        d_bn, _ = recorded(lambda: d4(r, r), times=3)
        steps["rsss_adversarial"] = (dict(collections.Counter(s_bn) + collections.Counter(d_bn)),
                                     s_pools)
        del g3, s3, d3, g4, s4, d4, vgg
    torch.cuda.empty_cache()
    bn = [(step, shape, k) for step, (bns, _) in steps.items() for shape, k in bns.items()]
    pools = [(step, shape, k) for step, (_, pls) in steps.items() for shape, k in pls.items()]
    return bn, pools


def bn_rows(torch, shapes):
    """channel_sums and channel_sums_pair at every distinct BN input, bf16:
    within 1e-5 of the sum of magnitudes per channel of the plain version."""
    from fcdgan_tpu_torch.ops.channel_sums import (channel_sums, channel_sums_pair,
                                                   channel_sums_pair_plain,
                                                   channel_sums_plain, reduction_plan)

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt = torch.bfloat16
    for step, shape, count in shapes:
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.3).to(dt)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dt)
        xf, dyf = x.float().reshape(-1, c), dy.float().reshape(-1, c)
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        zero = torch.zeros(c, device="cuda")
        one = torch.ones(c, device="cuda")
        cases = (
            ("channel_sums", 1, lambda: channel_sums(x, square=True),
             lambda: channel_sums_plain(x, square=True),
             lambda: torch.var_mean(x, dim=(0, 1, 2), correction=0),
             (xf.abs().sum(0), xf.square().sum(0)), x.numel() * dt.itemsize, 3 * x.numel()),
            ("channel_sums_pair", 2, lambda: channel_sums_pair(dy, x),
             lambda: channel_sums_pair_plain(dy, x),
             lambda: torch.batch_norm_backward_reduce(dy_nchw, x_nchw, zero, one, None,
                                                      True, False, False),
             (dyf.abs().sum(0), (dyf * xf).abs().sum(0)), 2 * x.numel() * dt.itemsize,
             3 * x.numel()))
        for name, inputs, kernel, plain, library, scales, in_bytes, flops in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            launched = device_launches(torch, kernel)
            same = repeatable(torch, kernel)
            plan = reduction_plan(x.numel() // c, c, dt.itemsize, sms, inputs)
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            ratio = max(((g - w).abs() / (1e-5 * sc + 1e-30)).max().item()
                        for g, w, sc in zip(got, want, scales))
            nbytes = in_bytes + 2 * c * 4
            bound_ms, bound_by = roofline(nbytes, flops, "float32")
            try:
                library_ms, library_error = cuda_ms(torch, library), None
            except (RuntimeError, TypeError) as e:  # the yardstick only
                library_ms, library_error = None, str(e)[:200]
            row = {"name": name, "layer": f"{step} {list(shape)}", "step": step,
                   "dtype": "bfloat16", "shape": list(shape), "per_step": count,
                   "max_abs_err": err, "err_over_tol": ratio,
                   "tol": "1e-5 * sum|x| per channel",
                   "blocks": plan.blocks * plan.ctiles, "rows_per_block": plan.rows_per_block,
                   "device_launches_per_call": launched[0],
                   "one_device_launch_each_of_3_calls": one_launch_each(launched),
                   "bitwise_repeatable": same,
                   "ms": cuda_ms(torch, kernel), "call_ms": call_ms(torch, kernel),
                   "plain_ms": cuda_ms(torch, plain, reps=5), "library_ms": library_ms,
                   "library_error": library_error, "bytes": nbytes, "flops": flops,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            phase("kernels", row)
            if not (ratio <= 1.0 and one_launch_each(launched) and same):
                raise AssertionError(f"{name} {shape}: error {ratio} x the tolerance, "
                                     f"device launches {launched}, repeatable {same}")
            rows.append(row)
        del x, dy, xf, dyf
    torch.cuda.empty_cache()
    return rows


def phase_pool_rows(torch, F, shapes):
    """phase_pool at every max-pool forward of a step, bf16 and f32:
    bit-equal to its plain version and to F.max_pool2d."""
    from fcdgan_tpu_torch.ops.phase_pool import phase_pool, phase_pool_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for step, shape, count in shapes:
            n, h, w, c = shape
            # post-ReLU activations, as the pools see them: many tied zeros
            x = torch.relu(torch.randn(shape, generator=gen, device="cuda")).to(dt)
            x_nchw = x.permute(0, 3, 1, 2)
            got, want = phase_pool(x), phase_pool_plain(x)
            lib = F.max_pool2d(x_nchw, 2).permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.equal(got, want) and torch.equal(got, lib)
            # the 2Ho x 2Wo input region read once, the output written once;
            # 3 compares/selects per output element
            nbytes = (n * 2 * (h // 2) * 2 * (w // 2) * c + got.numel()) * dt.itemsize
            bound_ms, bound_by = roofline(nbytes, 3 * got.numel(), "float32")
            row = {"name": "phase_pool", "layer": f"{step} {list(shape)}", "step": step,
                   "dtype": dtype_name, "shape": list(shape), "per_step": count,
                   "max_abs_err": err, "tol": 0.0, "bit_equal_plain_and_library": ok,
                   "ms": cuda_ms(torch, lambda: phase_pool(x)),
                   "call_ms": call_ms(torch, lambda: phase_pool(x)),
                   "plain_ms": cuda_ms(torch, lambda: phase_pool_plain(x), reps=5),
                   "library_ms": cuda_ms(torch, lambda: F.max_pool2d(x_nchw, 2)),
                   "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}
            phase("kernels", row)
            if not (ok and err == 0):
                raise AssertionError(f"phase_pool {shape} {dtype_name}: not bit-equal "
                                     f"(max abs err {err})")
            rows.append(row)
            del x, got, want, lib
    torch.cuda.empty_cache()
    return rows


def _gated(torch, module, hw):
    from fcdgan_tpu_torch.ops.conv3x3 import gate

    return sum(1 for m in module.modules()
               if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3)
               and m.stride == (1, 1) and gate(hw, hw, m.in_channels, m.out_channels))


def _model_counts(torch, side, nband=3):
    """Per forward at ``side`` px of the ``nband``-band models: gated 3x3
    convs of G and S (and of S's encoder, which split mode runs twice), BNs
    of G, S, S's encoder and D, S's Down pools, the VGG pools before the
    deepest tap, and the MS-SSIM levels as large as the window."""
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import _CFG, select_feature_layers

    net_g, net_s, net_d = Generator(nband), Segmentor(nband), Discriminator(nband)
    blocks = [(net_s.inc, 0), (net_s.down1, 1), (net_s.down2, 2), (net_s.down3, 3),
              (net_s.down4, 4), (net_s.up1, 3), (net_s.up2, 2), (net_s.up3, 1),
              (net_s.up4, 0)]
    deepest = max(select_feature_layers(1))
    seq, vgg_pools = 0, 0
    for c in _CFG:
        if seq > deepest:
            break
        vgg_pools += c == "M"
        seq += 1 if c == "M" else 2
    levels, hw = 0, side
    for _ in range(5):  # the default 5-level MS-SSIM
        levels += hw >= 11
        hw = (hw + hw % 2) // 2

    def bns(net):
        return sum(1 for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d))

    encoder = blocks[:5]
    return {"g_convs": _gated(torch, net_g, side),
            "s_convs": sum(_gated(torch, b, side >> level) for b, level in blocks),
            "s_enc_convs": sum(_gated(torch, b, side >> level) for b, level in encoder),
            "g_bns": bns(net_g), "s_bns": bns(net_s), "d_bns": bns(net_d),
            "s_enc_bns": sum(bns(b) for b, _ in encoder),
            "s_pools": sum(1 for name, _ in net_s.named_children() if name.startswith("down")),
            "vgg_pools": vgg_pools, "levels": levels}


@contextlib.contextmanager
def step_calls():
    """Within the block, the counts of the USSS joint steps and the WSSS
    adversarial steps as ``train.steps`` makes them (``step.eager``,
    ``step.graph_captures``, ``step.graph_replays``), whether a recording
    is open or not. On the card a batch shape's first call runs the step
    twice on the host, the eager step and its capture, and the kernel
    wrappers count the launches of both; a replay runs on the device alone,
    and the wrappers count none of it (``replay_phase`` counts a replay's
    kernels on the device)."""
    from fcdgan_tpu_torch.train import steps as steps_mod

    seen = collections.Counter()
    orig = steps_mod.count

    def counted(name, n=1):
        seen[name] += n
        orig(name, n)

    steps_mod.count = counted
    try:
        yield seen
    finally:
        steps_mod.count = orig


def host_steps(n_steps, seen):
    """Of ``n_steps`` graphable steps (``seen``: their ``step_calls``), the
    passes whose launches the kernel wrappers count: every step but the
    replays, and each capture once more."""
    return n_steps - seen["step.graph_replays"] + seen["step.graph_captures"]


def _launch_totals(per_step, n_steps):
    """Each kernel's launches in a phase: its launches per step of each kind
    times the number of steps of that kind."""
    return {name: sum(n * n_steps[kind] for kind, n in kinds.items())
            for name, kinds in per_step.items()}


def _split_counts(k, split):
    """S's gated convs, BNs and Down pools per forward and D's BNs per
    forward: with ``split`` the encoder's kernels (and all of D's) run once
    per branch, at half the batch."""
    if not split:
        return k["s_convs"], k["s_bns"], k["s_pools"], k["d_bns"]
    return (k["s_convs"] + k["s_enc_convs"], k["s_bns"] + k["s_enc_bns"], 2 * k["s_pools"],
            2 * k["d_bns"])


def derived_launches(torch, n_tiles, epochs=TRAIN_EPOCHS, steps=None, chunks=None,
                     split=False, seen=None):
    """Each kernel's launches in a USSS run, from the models' structure
    (``_model_counts``) and the steps per epoch (``steps``, else one per
    batch of ``n_tiles``) and inference chunks (``chunks``, else the fused
    plan of ``serve_chunks``): a G-pretrain step runs G forward and backward
    and the VGG on the target (no graph) and on the generated tiles; an
    S-init step runs G forward without a graph and S and the VGG (one
    stacked pass) forward and backward; a joint step both nets forward and
    backward; an inference chunk S in eval mode. ``split``: S's encoder runs
    once per branch (``_split_counts``), in eval mode too. ``seen``: the
    run's ``step_calls``, so that the joint steps are counted as the kernel
    wrappers count them (``host_steps``); without it, every step once,
    as the device runs them."""
    from fcdgan_tpu_torch.data.device_cache import serve_chunks

    k = _model_counts(torch, PATCH)
    steps = -(-n_tiles // BATCH) if steps is None else steps
    chunks = len(serve_chunks(n_tiles, BATCH)) if chunks is None else chunks
    n_steps = dict(zip(("g_pretrain", "s_init", "joint"), (e * steps for e in epochs)),
                   inference_chunk=chunks)
    if seen is not None:
        n_steps["joint"] = host_steps(n_steps["joint"], seen)
    sc, sb, sp, _ = _split_counts(k, split)
    gb, vp = k["g_bns"], k["vgg_pools"]
    gs_convs, levels = k["g_convs"] + sc, k["levels"]
    per_step = {
        "conv3x3": {"g_pretrain": k["g_convs"], "s_init": gs_convs, "joint": gs_convs,
                    "inference_chunk": sc},
        "pool_bwd": {"g_pretrain": vp, "s_init": sp + vp, "joint": sp + vp},
        "fused_ssim": {"g_pretrain": levels, "s_init": levels, "joint": levels},
        "channel_sums": {"g_pretrain": gb, "s_init": gb + sb, "joint": gb + sb},
        "channel_sums_pair": {"g_pretrain": gb, "s_init": sb, "joint": gb + sb},
        "phase_pool": {"g_pretrain": 2 * vp, "s_init": sp + vp, "joint": sp + vp,
                       "inference_chunk": sp}}
    return _launch_totals(per_step, n_steps), per_step


def derived_wsss_launches(torch, epochs=WSSS_EPOCHS, split=False, seen=None):
    """Each kernel's launches in the wsss phase: a G-pretrain step as in
    USSS (RGB perception); an adversarial step runs S forward twice and
    backward through both, D forward three times and backward through all
    three (two in the D update, one in the S loss), G in eval mode and the
    VGG (one stacked pass) forward and backward; an inference chunk S in
    train mode without a graph. ``split``: S's encoder and D run once per
    branch (``_split_counts``). ``seen``: the run's ``step_calls``, so that
    the adversarial steps are counted as the kernel wrappers count them
    (``host_steps``); without it, every step once, as the device runs
    them."""
    k = _model_counts(torch, WSSS_SIZE)
    n_c, n_nc = WSSS_SLICES
    n_steps = {"g_pretrain": epochs[0] * -(-n_nc // WSSS_UNC_BATCH),
               "adversarial": epochs[1] * -(-max(n_c, n_nc) // WSSS_BATCH),
               "inference_chunk": -(-n_c // WSSS_BATCH)}
    if seen is not None:
        n_steps["adversarial"] = host_steps(n_steps["adversarial"], seen)
    sc, sb, sp, db = _split_counts(k, split)
    gb, vp = k["g_bns"], k["vgg_pools"]
    per_step = {
        "conv3x3": {"g_pretrain": k["g_convs"], "adversarial": 2 * sc + k["g_convs"],
                    "inference_chunk": sc},
        "pool_bwd": {"g_pretrain": vp, "adversarial": 2 * sp + vp},
        "fused_ssim": {"g_pretrain": k["levels"], "adversarial": k["levels"]},
        "channel_sums": {"g_pretrain": gb, "adversarial": 2 * sb + 3 * db,
                         "inference_chunk": sb},
        "channel_sums_pair": {"g_pretrain": gb, "adversarial": 2 * sb + 3 * db},
        "phase_pool": {"g_pretrain": 2 * vp, "adversarial": 2 * sp + vp,
                       "inference_chunk": sp}}
    return _launch_totals(per_step, n_steps), per_step


def derived_rsss_launches(torch, n_train, n_test, epochs=RSSS_EPOCHS):
    """Each kernel's launches in the rsss phase, from the 4-band models'
    structure: a G-pretrain step as in USSS (per-band perception); an
    adversarial step runs S forward once and backward, D forward three
    times and backward through all three (two in the D update, one in the S
    loss), G in eval mode and the VGG (one stacked pass) forward and
    backward; a test-evaluation batch S in train mode without a graph; an
    inference chunk S in eval mode."""
    k = _model_counts(torch, RSSS_PATCH, RSSS_BANDS)
    test_batches = -(-n_test // RSSS_BATCH)
    n_steps = {"g_pretrain": epochs[0] * -(-n_train // RSSS_INIT_BATCH),
               "adversarial": epochs[1] * -(-n_train // RSSS_BATCH),
               "test_eval": epochs[1] * test_batches, "inference_chunk": test_batches}
    gb, sb, db = k["g_bns"], k["s_bns"], k["d_bns"]
    sp, vp = k["s_pools"], k["vgg_pools"]
    per_step = {
        "conv3x3": {"g_pretrain": k["g_convs"], "adversarial": k["s_convs"] + k["g_convs"],
                    "test_eval": k["s_convs"], "inference_chunk": k["s_convs"]},
        "pool_bwd": {"g_pretrain": vp, "adversarial": sp + vp},
        "fused_ssim": {"g_pretrain": k["levels"], "adversarial": k["levels"]},
        "channel_sums": {"g_pretrain": gb, "adversarial": sb + 3 * db, "test_eval": sb},
        "channel_sums_pair": {"g_pretrain": gb, "adversarial": sb + 3 * db},
        "phase_pool": {"g_pretrain": 2 * vp, "adversarial": sp + vp, "test_eval": sp,
                       "inference_chunk": sp}}
    return _launch_totals(per_step, n_steps), per_step


def make_model(torch, work, scene):
    """Seeded full-width Segmentor saved as SModel.pkl. The OutConv weights
    are widened and its bias centred on the first chunk's logits, so the
    density map holds both classes and every metric is finite."""
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.io.checkpoint import save_net
    from fcdgan_tpu_torch.models.segmentor import Segmentor

    torch.manual_seed(0)
    net = Segmentor(3).eval()
    with torch.no_grad():
        net.outc.conv.weight.mul_(50.0)
    stats_ds = ScenePairDataset(scene["x"], scene["y"], patch_size=(PATCH, PATCH),
                                overlap_padding=(0, 0))
    # writes the stats caches that tools.infer then reads
    scaler = Normalize(*dataset_meanstd(os.path.join(work, "T1_stats.txt"),
                                        os.path.join(work, "T2_stats.txt"), stats_ds))
    ds = ScenePairDataset(scene["x"], scene["y"], enhance=scaler,
                          patch_size=(PATCH, PATCH), overlap_padding=(PAD, PAD))
    cache = DeviceSceneCache(ds, scaler, "cuda")
    net.cuda()
    with torch.no_grad():
        d = net(*cache.tiles(torch.arange(min(BATCH, cache.n_tiles), device="cuda")))
        logit = torch.logit(d.clamp(1e-6, 1 - 1e-6)).median()
        net.outc.conv.bias.sub_(logit)
    path = os.path.join(work, "SModel.pkl")
    save_net(path, net)
    return path, ds, cache


@contextlib.contextmanager
def environ(**values):
    """Within the block, each named environment variable set to its value
    (None: unset); the old values come back after it."""
    old = {k: os.environ.get(k) for k in values}

    def put(items):
        for k, v in items.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(values)
    try:
        yield
    finally:
        put(old)


def derived_serve_launches(counters, k, n_chunks):
    """The launches of serving ``n_chunks`` chunks with an eval-mode S
    (``k`` from ``_model_counts``): its gated convs and Down pools per chunk,
    no BN statistics, no backward."""
    want = {name: 0 for name in counters}
    want.update(conv3x3=k["s_convs"] * n_chunks, phase_pool=k["s_pools"] * n_chunks)
    return want


def launch_counts(counters):
    """(each kernel's launches, conv3x3's per variant) since the last reset."""
    return ({name: fn.launches for name, fn in counters.items()},
            dict(counters["conv3x3"].launches_by_variant))


def all_wgmma(launches, variants):
    return variants == {"wgmma": launches["conv3x3"], "fma_f32": 0}


def serve_phase(torch, work, smodel):
    import numpy as np

    from fcdgan_tpu_torch.data.device_cache import serve_chunks
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.tools import infer

    argv = ["--dir", work, "--smodel", smodel, "--ref-name", "ref.tif",
            "--batch-size", str(BATCH), "--progress", "false"]
    counters = kernel_counters()
    n_tiles = math.ceil(SCENE / (PATCH - 2 * PAD)) ** 2
    with environ(FCDGAN_SERVE_BS=None):  # main() sets its default
        reset_launches(counters)
        out = infer.main(argv)
        launches, variants = launch_counts(counters)
        serve_bs = os.environ["FCDGAN_SERVE_BS"]
        n_chunks = len(serve_chunks(n_tiles, BATCH))
        warm = infer.main(argv)  # same scene again, everything built and cached
    want = derived_serve_launches(counters, _model_counts(torch, PATCH), n_chunks)
    density = open_raster(out["density_path"]).read_block()[..., 0]
    checks = {
        "density_exists": os.path.isfile(out["density_path"]),
        "color_exists": bool(out["color_path"]) and os.path.isfile(out["color_path"]),
        "density_shape": list(density.shape) == [SCENE, SCENE],
        "density_finite_in_0_1": bool(np.isfinite(density).all()
                                      and density.min() >= 0 and density.max() <= 1),
        "oa_f1_finite": all(isinstance(out.get(k), float) and math.isfinite(out[k])
                            for k in ("oa", "f1")),
        "fused": out["fused"],
        "launches": launches == want,
        "conv3x3_all_wgmma": all_wgmma(launches, variants),
    }
    phase("serve", {"px_per_s": out["px_per_s"], "seconds": out["seconds"],
                    "warm_px_per_s": warm["px_per_s"], "warm_seconds": warm["seconds"],
                    "pixels": out["pixels"], "serve_bs": serve_bs, "tiles": n_tiles,
                    "chunks": n_chunks, "launches": launches, "conv3x3_variants": variants,
                    "derived_launches": want, "oa": out["oa"], "f1": out["f1"],
                    "auc": out["auc"], "density_mean": float(density.mean()),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    return launches


def serve_bs_phase(torch, work, smodel):
    """The 2048² scene through tools.infer.run at FCDGAN_SERVE_BS 0 and 32,
    twice each in turns: the densities within one bf16 step, launches from
    each chunk plan. Returns the batch-exact density."""
    import numpy as np

    from fcdgan_tpu_torch.data.device_cache import serve_chunks
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.tools import infer

    counters = kernel_counters()
    k = _model_counts(torch, PATCH)
    n_tiles = math.ceil(SCENE / (PATCH - 2 * PAD)) ** 2
    res = {}
    for bs in ("0", "32", "0", "32"):
        with environ(FCDGAN_SERVE_BS=bs):
            reset_launches(counters)
            out = infer.run(infer.InferConfig(dir=work, smodel=smodel, ref_name="ref.tif",
                                              batch_size=BATCH, ext=f"_bs{bs}", progress=False))
            n_chunks = len(serve_chunks(n_tiles, BATCH))
        launches, variants = launch_counts(counters)
        r = res.setdefault(bs, {"px_per_s": [], "chunks": n_chunks, "launches": launches,
                                "conv3x3_variants": variants,
                                "derived_launches": derived_serve_launches(counters, k, n_chunks)})
        r["px_per_s"].append(out["px_per_s"])
        r["density"] = open_raster(out["density_path"]).read_block()[..., 0]
    moved = res["0"]["density"] != res["32"]["density"]
    diff = float(np.abs(res["0"]["density"] - res["32"]["density"]).max())
    checks = {"density_diff_within_one_bf16_step": diff <= BF16_STEP}
    for bs, r in res.items():
        checks[f"launches_bs{bs}"] = r["launches"] == r["derived_launches"]
        checks[f"conv3x3_all_wgmma_bs{bs}"] = all_wgmma(r["launches"], r["conv3x3_variants"])
    phase("serve_bs", {"pixels": SCENE * SCENE, "max_abs_density_diff": diff, "tol": BF16_STEP,
                       "share_of_pixels_moved": float(moved.mean()),
                       **{f"bs{bs}": {key: v for key, v in r.items() if key != "density"}
                          for bs, r in res.items()},
                       "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve_bs checks failed: {checks}")
    return res["0"]["density"]


def serve_stream_phase(torch, work, smodel, fused):
    """The 2048² scene on the streaming path (host tiles, writer thread), bf16,
    downloads in float32 and uint8, each twice: within 1e-3 (uint8: 1/510 +
    1e-3) of the fused batch-exact density ``fused``, 3 conv3x3 and 4
    phase_pool launches a batch."""
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.tools import infer

    counters = kernel_counters()
    batches = math.ceil(math.ceil(SCENE / (PATCH - 2 * PAD)) ** 2 / BATCH)
    want = derived_serve_launches(counters, _model_counts(torch, PATCH), batches)
    res, checks = {}, {}
    for dd, tol in (("float32", 1e-3), ("uint8", 1 / 510 + 1e-3)) * 2:
        reset_launches(counters)
        out = infer.run(infer.InferConfig(dir=work, smodel=smodel, ref_name="ref.tif",
                                          batch_size=BATCH, device_feed="stream",
                                          density_dtype=dd, ext=f"_stream_{dd}",
                                          progress=False))
        launches, variants = launch_counts(counters)
        diff = float(np.abs(open_raster(out["density_path"]).read_block()[..., 0]
                            - fused).max())
        r = res.setdefault(dd, {"px_per_s": [], "max_abs_diff_to_fused": diff, "tol": tol,
                                "launches": launches, "conv3x3_variants": variants})
        r["px_per_s"].append(out["px_per_s"])
        checks[f"{dd}_within_tol"] = diff <= tol and not out["fused"]
        checks[f"{dd}_metrics_finite"] = all(math.isfinite(out[key]) for key in ("oa", "f1"))
        checks[f"{dd}_launches"] = launches == want
        checks[f"{dd}_conv3x3_all_wgmma"] = all_wgmma(launches, variants)
    phase("serve_stream", {"pixels": SCENE * SCENE, "batches": batches,
                           "derived_launches": want, **res, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve_stream checks failed: {checks}")


def parity_phase(torch, smodel, ds, gpu_cache):
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.io.checkpoint import load_segmentor

    ids = torch.arange(2)
    out = {}
    for dev in ("cuda", "cpu"):
        net = load_segmentor(smodel, device=dev, compute_dtype=torch.float32)
        cache = gpu_cache if dev == "cuda" else DeviceSceneCache(ds, ds.enhance, "cpu")
        with torch.no_grad():
            out[dev] = net(*cache.tiles(ids.to(dev))).cpu()
    diff = (out["cuda"] - out["cpu"]).abs().max().item()
    ok = diff <= 1e-3 and bool(torch.isfinite(out["cuda"]).all())
    phase("parity", {"tiles": 2, "shape": list(out["cuda"].shape),
                     "max_abs_density_diff": diff, "tol": 1e-3, "ok": ok})
    if not ok:
        raise AssertionError(f"parity: max abs density diff {diff} > 1e-3")


def reset_launches(counters):
    """Every kernel's launch count, and conv3x3's per variant, set to 0."""
    for fn in counters.values():
        fn.launches = 0
    counters["conv3x3"].launches_by_variant.update(wgmma=0, fma_f32=0)


def kernel_counters():
    from fcdgan_tpu_torch.ops.channel_sums import channel_sums, channel_sums_pair
    from fcdgan_tpu_torch.ops.conv3x3 import conv3x3
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level
    from fcdgan_tpu_torch.ops.phase_pool import phase_pool
    from fcdgan_tpu_torch.ops.pool_bwd import pool_bwd

    return {"conv3x3": conv3x3, "pool_bwd": pool_bwd, "fused_ssim": ssim_level,
            "channel_sums": channel_sums, "channel_sums_pair": channel_sums_pair,
            "phase_pool": phase_pool}


def train_phase(torch, work):
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene
    from fcdgan_tpu_torch.demos import demo_usss
    from fcdgan_tpu_torch.io.checkpoint import load_segmentor

    tdir = os.path.join(work, "train")
    make_usss_scene(tdir, TRAIN_SCENE, TRAIN_SCENE, 3, seed=1, dtype="uint16",
                    rects=((150, 200, 120, 90), (600, 450, 150, 210)))
    argv = train_args(tdir, "_smoke", TRAIN_EPOCHS)
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    t0 = time.perf_counter()
    with step_calls() as seen:
        out = demo_usss.main(argv)
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    want, per_step = derived_launches(torch, out["tiles"], seen=seen)
    ev = out["evaluator"]
    density = open_raster(out["density_path"]).read_block()[..., 0]
    load_segmentor(out["smodel_path"])  # strict load of the reference state_dict
    losses = [v for ph in out["epoch_metrics"].values() for m in ph for v in m.values()]
    metrics = {"oa": float(ev.Pixel_Accuracy()), "f1": float(ev.Pixel_F1_score()),
               "auc": float(out["auc"])}
    sec = out["epoch_seconds"]
    warm = sec["joint"][1:]
    checks = {
        "artifacts": all(os.path.isfile(out[k]) for k in (
            "density_path", "color_path", "para_path", "smodel_path", "gmodel_path")),
        "epochs": [len(v) for k, v in sec.items() if k != "infer"] == list(TRAIN_EPOCHS),
        "losses_finite": bool(losses) and all(math.isfinite(v) for v in losses),
        "density_in_0_1": bool(list(density.shape) == [TRAIN_SCENE, TRAIN_SCENE]
                               and np.isfinite(density).all()
                               and density.min() >= 0 and density.max() <= 1),
        "metrics_finite": all(math.isfinite(v) for v in metrics.values()),
        "launches": launches == want,
        "conv3x3_all_wgmma": all_wgmma(launches, variants),
        "joint_graphed": seen["step.graph_replays"] > 0
        and seen["step.eager"] == seen["step.graph_captures"] > 0,
    }
    phase("train", {
        "seconds": seconds, "tiles": out["tiles"],
        "phase_seconds": {"g_pretrain": sum(sec["g"]), "s_init": sum(sec["s"]),
                          "joint": sum(sec["joint"]), "inference": sec["infer"]},
        "joint_epoch_seconds": sec["joint"],
        "joint_epochs_per_s_warm": len(warm) / sum(warm),
        "tile_mpx_per_s_warm": out["tiles"] * PATCH * PATCH * len(warm) / sum(warm) / 1e6,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "conv3x3_variants": variants, "derived_launches": want,
        "per_step": per_step, "step_calls": dict(seen),
        "epoch_metrics": out["epoch_metrics"], **metrics, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")
    return launches, tdir, out


def train_args(tdir, ext, epochs, *extra):
    """demo_usss on the train phase's 1024² scene at its settings (bf16,
    patch 220, batch 10), ``epochs`` (G pretrain, S init, joint)."""
    return ["--dir", tdir, "--compute-dtype", "bfloat16", "--batch-size", str(BATCH),
            "--patch-size", f"{PATCH},{PATCH}", "--overlap-padding", f"{PAD},{PAD}",
            "--init-num-epochs-g", str(epochs[0]), "--init-num-epochs-s", str(epochs[1]),
            "--num-epochs", str(epochs[2]), "--log-tensorboard", "false",
            "--progress", "false", "--ext", ext, *extra]


@contextlib.contextmanager
def record_ssim_levels():
    """Within the block, every MS-SSIM level the port computes is kept in the
    yielded list as (x, y, the level's other arguments, (ssim, cs) tables).
    A level met while a CUDA graph is being captured computes nothing (the
    joint step's first call on the card captures after its eager step), so
    it is not kept."""
    import torch

    from fcdgan_tpu_torch.ops import ssim as ssim_mod

    orig, levels = ssim_mod._ssim_level, []

    def level(x, y, *args):
        out = orig(x, y, *args)
        if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
            levels.append((x.detach(), y.detach(), args, tuple(t.detach() for t in out)))
        return out

    ssim_mod._ssim_level = level
    try:
        yield levels
    finally:
        ssim_mod._ssim_level = orig


def train_parity_phase(torch, tdir, siamese_stats="joint"):
    """One joint step on 2 tiles in f32 from the same seeded weights, on the
    card (the kernels) and on the CPU (the plain versions), with S in
    ``siamese_stats`` mode. Besides the losses, gradient norms and BN stats,
    the step's own MS-SSIM levels (its masked target and generated tiles)
    are compared before the relu and the product: on the card each level's
    kernel tables against the plain version on the same inputs (atol 2e-5),
    and the card's tables against the CPU's (atol 1e-4, as their inputs come
    from the two devices' G and S forwards)."""
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level_plain
    from fcdgan_tpu_torch.train.optim import adam
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

    scaler = Normalize(*dataset_meanstd(os.path.join(tdir, "T1_stats.txt"),
                                        os.path.join(tdir, "T2_stats.txt"), None))
    ds = ScenePairDataset(os.path.join(tdir, "T1.tif"), os.path.join(tdir, "T2.tif"),
                          ref_path=os.path.join(tdir, "ref.tif"), enhance=scaler,
                          patch_size=(PATCH, PATCH), overlap_padding=(PAD, PAD))
    torch.manual_seed(0)
    nets0 = (Generator(3), Segmentor(3))
    vggp = vgg16_random_params(0)
    res = {}
    for dev in ("cuda", "cpu"):
        net_g, net_s = Generator(3), Segmentor(3, siamese_stats=siamese_stats)
        for a, b in zip((net_g, net_s), nets0):
            a.load_state_dict(b.state_dict())
            a.to(dev)
        steps = USSSSteps(net_g, net_s, adam(net_g.parameters()), adam(net_s.parameters()),
                          VGG16Weights(vggp, dev), PerceptionConfig((29,), True),
                          0.4, 0.65, 0.0, ds.grid.interior_sizes(), (PAD, PAD))
        cache = DeviceSceneCache(ds, scaler, dev)
        db = cache.complete({"item": [0, 1], "weight": [1.0, 1.0]})
        with record_ssim_levels() as levels:
            m = steps.joint(db["x"], db["y"], db["ref"], db["item"], db["weight"],
                            1e-4, 1e-4)
        norms = {name: torch.sqrt(sum(p.grad.double().square().sum()
                                      for p in net.parameters() if p.grad is not None)).item()
                 for name, net in (("G", net_g), ("S", net_s))}
        stats = torch.cat([b.detach().cpu().reshape(-1) for net in (net_g, net_s)
                           for n, b in net.named_buffers() if n.endswith(("mean", "var"))])
        if dev == "cuda":  # the kernel on the step's own level inputs
            kernel_err = max((a - b).abs().max().item()
                             for x, y, (rng, win, sigma, k), got in levels
                             for a, b in zip(got, ssim_level_plain(x, y, rng, win, sigma,
                                                                   *k)))
        tables = [torch.stack(out).cpu() for *_, out in levels]
        res[dev] = ({k: float(v) for k, v in m.items() if k != "confusion"}, norms, stats,
                    tables)
        del steps, cache, db, levels
    (mg, ng, sg, tg), (mc, nc, sc, tc) = res["cuda"], res["cpu"]
    loss_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    norm_rel = max(abs(ng[k] - nc[k]) / nc[k] for k in nc)
    stats_err = (sg - sc).abs().max().item()
    table_err = max((a - b).abs().max().item() for a, b in zip(tg, tc))
    ok = (loss_rel <= 1e-4 and norm_rel <= 1e-3 and stats_err <= 1e-4
          and len(tg) == len(tc) == 5 and kernel_err <= 2e-5 and table_err <= 1e-4)
    name = "train_parity" if siamese_stats == "joint" else "usss_split_parity"
    phase(name, {"tiles": 2, "siamese_stats": siamese_stats, "losses_cuda": mg,
                 "losses_cpu": mc, "grad_norms_cuda": ng, "grad_norms_cpu": nc,
                 "loss_max_rel": loss_rel, "grad_norm_max_rel": norm_rel,
                 "bn_stats_max_abs": stats_err, "ssim_levels": len(tg),
                 "ssim_tables_cuda": [t.tolist() for t in tg],
                 "ssim_kernel_vs_plain_max_abs": kernel_err,
                 "ssim_tables_cuda_vs_cpu_max_abs": table_err,
                 "tols": {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "bn_stats_abs": 1e-4,
                          "ssim_kernel_abs": 2e-5, "ssim_tables_abs": 1e-4}, "ok": ok})
    if not ok:
        raise AssertionError(f"{name}: losses {loss_rel}, grad norms {norm_rel}, "
                             f"BN stats {stats_err}, {len(tg)} SSIM levels, kernel "
                             f"{kernel_err}, tables {table_err}")


def wsss_phase(torch, work):
    import numpy as np

    from fcdgan_tpu_torch.data.raster import read_image
    from fcdgan_tpu_torch.data.synthetic import make_whu_dataset
    from fcdgan_tpu_torch.demos import demo_wsss
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.train.steps import WSSSSteps

    root = os.path.join(work, "whu")
    make_whu_dataset(root, n_changed=WSSS_SLICES[0], n_unchanged=WSSS_SLICES[1],
                     size=WSSS_SIZE, seed=2)
    argv = wsss_args(root, "_smoke", WSSS_EPOCHS)
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    t0 = time.perf_counter()
    with first_step(WSSSSteps, "g_pretrain") as first, step_calls() as seen:
        out = demo_wsss.main(argv)
    out["first_g_step"] = first
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    want, per_step = derived_wsss_launches(torch, seen=seen)
    names = sorted(n for n in os.listdir(os.path.join(root, "before")) if n.endswith(".tif"))
    changed = [ln.split(",")[0] for ln in open(os.path.join(root, "label.txt")).read().split()
               if ln.endswith(",1")]
    maps_ok = all(
        read_image(os.path.join(out["out_dir"], n)).shape == (WSSS_SIZE, WSSS_SIZE, 3)
        and read_image(os.path.join(out["density_dir"], n)).shape == (WSSS_SIZE, WSSS_SIZE, 1)
        for n in changed)
    for key, cls in (("smodel_path", Segmentor), ("gmodel_path", Generator),
                     ("dmodel_path", Discriminator)):  # strict loads
        cls(3).load_state_dict(torch.load(out[key], weights_only=True), strict=True)
    ev = out["evaluator"]
    metrics = {"oa": float(ev.Pixel_Accuracy()), "f1": float(ev.Pixel_F1_score()),
               "kappa": float(ev.Pixel_Kappa())}
    losses = [v for ph in out["epoch_metrics"].values() for m in ph for v in m.values()]
    sec = out["epoch_seconds"]
    warm = sec["adv"][1:]
    pairs = out["pairs"]
    checks = {
        "slices": len(names) == sum(WSSS_SLICES) and len(changed) == WSSS_SLICES[0],
        "maps": maps_ok,
        "artifacts": all(os.path.isfile(out[k]) for k in (
            "para_path", "smodel_path", "gmodel_path", "dmodel_path")),
        "epochs": [len(sec["g"]), len(sec["adv"])] == list(WSSS_EPOCHS),
        "losses_finite": bool(losses) and all(math.isfinite(v) for v in losses),
        "metrics_finite": all(math.isfinite(v) for v in metrics.values()),
        "confusion_covers_changed": bool(
            ev.confusion_matrix.sum() == WSSS_SLICES[0] * WSSS_SIZE ** 2),
        "launches": launches == want,
        "conv3x3_all_wgmma": all_wgmma(launches, variants),
        "adversarial_graphed": seen["step.graph_replays"] > 0
        and seen["step.eager"] == seen["step.graph_captures"] > 0,
    }
    phase("wsss", {
        "seconds": seconds, "pairs": pairs, "slice_px": WSSS_SIZE,
        "phase_seconds": {"g_pretrain": sum(sec["g"]), "adversarial": sum(sec["adv"]),
                          "inference": sec["infer"]},
        "g_epoch_seconds": sec["g"], "adv_epoch_seconds": sec["adv"],
        "adv_epochs_per_s_warm": len(warm) / sum(warm),
        "slice_mpx_per_s_warm": 2 * pairs * WSSS_SIZE ** 2 * len(warm) / sum(warm) / 1e6,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "conv3x3_variants": variants, "derived_launches": want,
        "per_step": per_step, "step_calls": dict(seen),
        "epoch_metrics": out["epoch_metrics"], **metrics, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"wsss checks failed: {checks}")
    return launches, root, out


def wsss_args(root, ext, epochs, *extra):
    """demo_wsss over the WHU set at ``root`` at the wsss phase's settings,
    ``epochs`` (G pretrain, adversarial); a later run reuses the first
    run's GModel.pkl and skips the G pretrain."""
    return ["--img-dir-x", os.path.join(root, "before"),
            "--img-dir-y", os.path.join(root, "after"),
            "--ref-dir", os.path.join(root, "Label"), "--label-dir", root,
            "--out-g-model-dir", os.path.join(root, "GModel"),
            "--compute-dtype", "bfloat16", "--batch-size", str(WSSS_BATCH),
            "--unc-batch-size", str(WSSS_UNC_BATCH), "--perception-layer", "1",
            "--init-num-epochs-g", str(epochs[0]), "--num-epochs", str(epochs[1]),
            "--log-tensorboard", "false", "--progress", "false", "--ext", ext, *extra]


def wsss_parity_phase(torch, root, siamese_stats="joint"):
    """One adversarial step on 2 pairs in f32 from the same seeded weights,
    on the card (the kernels) and on the CPU (the plain versions), S and D
    in ``siamese_stats`` mode: losses, S and D gradient norms, BN running
    stats of S and D; and on the card each of the step's own BN statistics
    (the kernels' outputs, recorded in ``ops.fused_bn``) against the plain
    sums of the same inputs, one call per BN pass."""
    from fcdgan_tpu_torch.data.datasets import WHUPairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceWHUCache
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
    from fcdgan_tpu_torch.ops import fused_bn
    from fcdgan_tpu_torch.ops.channel_sums import channel_sums_pair_plain, channel_sums_plain
    from fcdgan_tpu_torch.train import schedules
    from fcdgan_tpu_torch.train.optim import adam, rmsprop
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, WSSSSteps

    dirs = (os.path.join(root, "before"), os.path.join(root, "after"),
            os.path.join(root, "Label"), root)
    scaler = Normalize(*dataset_meanstd(os.path.join(dirs[0], "stats_meanstd.txt"),
                                        os.path.join(dirs[1], "stats_meanstd.txt"), None))
    pair_ds = WHUPairDataset(*dirs, scale=scaler, rng=random.Random(0))
    torch.manual_seed(0)
    nets0 = (Generator(3), Segmentor(3), Discriminator(3))
    vggp = vgg16_random_params(0)
    res = {}
    for dev in ("cuda", "cpu"):
        net_g = Generator(3)
        net_s = Segmentor(3, siamese_stats=siamese_stats)
        net_d = Discriminator(3, siamese_stats=siamese_stats)
        for a, b in zip((net_g, net_s, net_d), nets0):
            a.load_state_dict(b.state_dict())
            a.to(dev)
        steps = WSSSSteps(net_g, net_s, net_d, adam(net_g.parameters()),
                          rmsprop(net_s.parameters()), rmsprop(net_d.parameters()),
                          VGG16Weights(vggp, dev), PerceptionConfig((29,), False),
                          0.5, 0.0, 0.2, 1.6, 1.0, 1.5, 0.6)
        cache = DeviceWHUCache(pair_ds, scaler, dev)
        db = cache.complete_pair({"c_item": [0, 1], "nc_item": [0, 1], "weight": [1.0, 1.0]})
        with record_calls(fused_bn, "channel_sums", clone=True) as fwd, \
                record_calls(fused_bn, "channel_sums_pair", clone=True) as bwd:
            m = steps.adversarial(db["c_x"], db["c_y"], db["c_ref"], db["nc_x"], db["nc_y"],
                                  db["weight"], schedules.S_ADV_WSSS(0), schedules.D_ADV_WSSS(0))
        norms = {name: torch.sqrt(sum(p.grad.double().square().sum()
                                      for p in net.parameters() if p.grad is not None)).item()
                 for name, net in (("S", net_s), ("D", net_d))}
        stats = torch.cat([b.detach().cpu().reshape(-1) for net in (net_s, net_d)
                           for n, b in net.named_buffers() if n.endswith(("mean", "var"))])
        if dev == "cuda":  # the kernels on the step's own BN inputs
            kernel_ratio = 0.0
            for (x,), got in fwd:
                xf = x.float().reshape(-1, x.shape[-1])
                for g, w, sc in zip(got, channel_sums_plain(x, True),
                                    (xf.abs().sum(0), xf.square().sum(0))):
                    kernel_ratio = max(kernel_ratio,
                                       ((g - w).abs() / (1e-5 * sc + 1e-30)).max().item())
            for (a, b), got in bwd:
                af, bf = a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1])
                for g, w, sc in zip(got, channel_sums_pair_plain(a, b),
                                    (af.abs().sum(0), (af * bf).abs().sum(0))):
                    kernel_ratio = max(kernel_ratio,
                                       ((g - w).abs() / (1e-5 * sc + 1e-30)).max().item())
            n_calls = (len(fwd), len(bwd))
        res[dev] = ({k: float(v) for k, v in m.items() if k != "confusion"}, norms, stats)
        del steps, cache, db, fwd, bwd
    (mg, ng, sg), (mc, nc, sc) = res["cuda"], res["cpu"]
    loss_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    norm_rel = max(abs(ng[k] - nc[k]) / nc[k] for k in nc)
    stats_err = (sg - sc).abs().max().item()
    k = _model_counts(torch, WSSS_SIZE)
    _, sb, _, db = _split_counts(k, siamese_stats == "split")
    want_calls = (2 * sb + 3 * db,) * 2  # S on both pairs, D three times
    ok = (loss_rel <= 1e-4 and norm_rel <= 1e-3 and stats_err <= 1e-4
          and kernel_ratio <= 1.0 and n_calls == want_calls)
    name = "wsss_parity" if siamese_stats == "joint" else "wsss_split_parity"
    phase(name, {"pairs": 2, "siamese_stats": siamese_stats, "losses_cuda": mg,
                 "losses_cpu": mc, "grad_norms_cuda": ng, "grad_norms_cpu": nc,
                 "loss_max_rel": loss_rel, "grad_norm_max_rel": norm_rel,
                 "bn_stats_max_abs": stats_err, "bn_kernel_calls": n_calls,
                 "bn_kernel_calls_derived": want_calls,
                 "bn_kernel_err_over_tol": kernel_ratio,
                 "tols": {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "bn_stats_abs": 1e-4,
                          "bn_kernel": "1e-5 * sum|x| per channel"}, "ok": ok})
    if not ok:
        raise AssertionError(f"{name}: losses {loss_rel}, grad norms {norm_rel}, "
                             f"BN stats {stats_err}, BN kernels {kernel_ratio} x tol over "
                             f"{n_calls} calls")


def rsss_phase(torch, work):
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.data.synthetic import make_oscd_dataset
    from fcdgan_tpu_torch.demos import demo_rsss
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.train.steps import RSSSSteps

    root = os.path.join(work, "oscd")
    # change rectangles across the scene; the regions grow 40 px around them
    make_oscd_dataset(root, *RSSS_SCENES, xsize=RSSS_SCENE, ysize=RSSS_SCENE, nband=RSSS_BANDS,
                      region_expand=40, seed=3, dtype=np.uint16,
                      rects=((150, 180, 120, 90), (600, 420, 150, 210), (820, 760, 110, 140),
                             (300, 700, 90, 160)))
    argv = rsss_args(root, "_smoke", RSSS_EPOCHS)
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    t0 = time.perf_counter()
    with first_step(RSSSSteps, "g_pretrain") as first:
        out = demo_rsss.main(argv)
    out["first_g_step"] = first
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    n_train, n_test = out["tiles"], out["test_tiles"]
    want, per_step = derived_rsss_launches(torch, n_train, n_test)
    rasters_ok = True
    for scene in RSSS_SCENES[1]:
        d = os.path.join(root, scene, "ImagePair")
        density = open_raster(os.path.join(d, out["density_name"])).read_block()
        color = open_raster(os.path.join(d, out["color_name"])).read_block()
        rasters_ok &= bool(density.shape == color.shape == (RSSS_SCENE, RSSS_SCENE, 1)
                           and np.isfinite(density).all()
                           and density.min() >= 0 and density.max() <= 1
                           and set(np.unique(color).tolist()) <= {0.0, 1.0, 2.0, 3.0})
    for key, cls in (("smodel_path", Segmentor), ("gmodel_path", Generator),
                     ("dmodel_path", Discriminator)):  # strict loads at 4 bands
        cls(RSSS_BANDS).load_state_dict(torch.load(out[key], weights_only=True), strict=True)
    ev, test_ev = out["evaluator"], out["test_evaluator"]
    metrics = {"oa": float(ev.Pixel_Accuracy()), "f1": float(ev.Pixel_F1_score()),
               "kappa": float(ev.Pixel_Kappa()), "test_oa": float(test_ev.Pixel_Accuracy()),
               "test_f1": float(test_ev.Pixel_F1_score()),
               "test_kappa": float(test_ev.Pixel_Kappa())}
    # the losses and the train and test accuracies of every epoch; F1 is
    # reported, not checked: it is NaN while no pixel is detected as changed
    values = [v for ph in out["epoch_metrics"].values() for m in ph
              for key, v in m.items() if key != "f1"]
    sec = out["epoch_seconds"]
    warm = sec["adv"][1:]
    test_px = len(RSSS_SCENES[1]) * RSSS_SCENE ** 2
    checks = {
        "tiles": (n_train, n_test) == (72, 36),
        "rasters": rasters_ok,
        "artifacts": all(os.path.isfile(out[k]) for k in (
            "para_path", "smodel_path", "gmodel_path", "dmodel_path")),
        "epochs": [len(sec["g"]), len(sec["adv"]), len(sec["test"])] == [
            RSSS_EPOCHS[0], RSSS_EPOCHS[1], RSSS_EPOCHS[1]],
        "losses_and_epoch_metrics_finite": bool(values) and all(math.isfinite(v)
                                                                for v in values),
        "metrics_finite": all(math.isfinite(v) for key, v in metrics.items()
                              if not key.endswith("f1")),
        "confusions_cover_test_interiors": bool(
            ev.confusion_matrix.sum() == test_px == test_ev.confusion_matrix.sum()),
        "launches": launches == want,
        "conv3x3_all_wgmma": all_wgmma(launches, variants),
    }
    phase("rsss", {
        "seconds": seconds, "tiles": n_train, "test_tiles": n_test, "tile_px": RSSS_PATCH,
        "phase_seconds": {"g_pretrain": sum(sec["g"]), "adversarial": sum(sec["adv"]),
                          "test_eval": sum(sec["test"]), "inference": sec["infer"]},
        "g_epoch_seconds": sec["g"], "adv_epoch_seconds": sec["adv"],
        "test_eval_seconds": sec["test"],
        "adv_epochs_per_s_warm": len(warm) / sum(warm),
        "tile_mpx_per_s_warm": n_train * RSSS_PATCH ** 2 * len(warm) / sum(warm) / 1e6,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "conv3x3_variants": variants, "derived_launches": want,
        "per_step": per_step,
        "epoch_metrics": out["epoch_metrics"], **metrics, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"rsss checks failed: {checks}")
    return launches, root, out


def rsss_args(root, ext, epochs, *extra):
    """demo_rsss over the OSCD layout at ``root`` at the rsss phase's
    settings, ``epochs`` (G pretrain, adversarial); a later run reuses the
    first run's GModel.pkl."""
    return ["--img-dir", root, "--out-g-model-dir", os.path.join(root, "GModel"),
            "--compute-dtype", "bfloat16", "--init-batch-size", str(RSSS_INIT_BATCH),
            "--batch-size", str(RSSS_BATCH), "--patch-size", f"{RSSS_PATCH},{RSSS_PATCH}",
            "--init-num-epochs-g", str(epochs[0]), "--num-epochs", str(epochs[1]),
            "--log-tensorboard", "false", "--progress", "false", "--ext", ext, *extra]


def _bn_stats(torch, *nets):
    """The BN running means and variances of ``nets``, flat, on the CPU."""
    return torch.cat([b.detach().cpu().reshape(-1) for net in nets
                      for n, b in net.named_buffers() if n.endswith(("mean", "var"))])


def rsss_parity_phase(torch, root):
    """One adversarial step on 2 tiles and then one train-mode test
    evaluation batch of 2 tiles, f32, from the same seeded weights, on the
    card (the kernels) and on the CPU (the plain versions): losses, S and D
    gradient norms, S and D BN running stats after both calls; and on the
    card each BN statistic of the two calls (the kernels' outputs, recorded
    in ``ops.fused_bn``) against the plain sums of the same inputs, and the
    step's 5 MS-SSIM levels at C = 4, kernel against plain version.

    The test evaluation runs S from the card's updated weights on both
    devices: RMSprop's first step moves every weight by about 10 x lr x
    sign(gradient), so an element within float noise of zero leaves the two
    devices' weights 2e-3 apart at the S learning rate of epoch 0 (1e-4),
    and a forward of the two updates could not be held at 1e-4."""
    from fcdgan_tpu_torch.data.datasets import OSCDDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceOSCDCache
    from fcdgan_tpu_torch.demos.demo_rsss import _scene_scalers
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
    from fcdgan_tpu_torch.ops import fused_bn
    from fcdgan_tpu_torch.ops.channel_sums import channel_sums_pair_plain, channel_sums_plain
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level_plain
    from fcdgan_tpu_torch.train import schedules
    from fcdgan_tpu_torch.train.optim import adam, rmsprop
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, RSSSSteps

    def scene_list(txt):  # the statsMS caches the rsss phase wrote
        return OSCDDataset(root, txt, scaler=_scene_scalers(root, txt, (RSSS_PATCH,) * 2,
                                                            "statsMS"),
                           patch_size=(RSSS_PATCH,) * 2, overlap_padding=(PAD, PAD))

    train, test = scene_list("train.txt"), scene_list("test.txt")
    # two train tiles that hold a region, so that both region losses are live
    has_region = (i for i in range(len(train)) if train[i][4].any())
    items = {"train": [next(has_region), next(has_region)], "test": [0, 1]}
    k = _model_counts(torch, RSSS_PATCH, RSSS_BANDS)
    torch.manual_seed(0)
    nets0 = (Generator(RSSS_BANDS), Segmentor(RSSS_BANDS), Discriminator(RSSS_BANDS))
    vggp = vgg16_random_params(0)
    res, s_after = {}, None
    for dev in ("cuda", "cpu"):
        net_g, net_s, net_d = (type(n)(RSSS_BANDS) for n in nets0)
        for a, b in zip((net_g, net_s, net_d), nets0):
            a.load_state_dict(b.state_dict())
            a.to(dev)
        steps = RSSSSteps(net_g, net_s, net_d, adam(net_g.parameters()),
                          rmsprop(net_s.parameters()), rmsprop(net_d.parameters()),
                          VGG16Weights(vggp, dev), PerceptionConfig((29,), True),
                          0.1, 0.0, 0.5, 0.02, 1.0, 2.0, train.interior_sizes(), (PAD, PAD),
                          test_interior_sizes=test.interior_sizes())
        db, tb = ({"item": items[n], "weight": [1.0, 1.0]} for n in ("train", "test"))
        db = DeviceOSCDCache(train, dev).complete(db)
        tb = DeviceOSCDCache(test, dev).complete(tb)
        with record_calls(fused_bn, "channel_sums", clone=True) as fwd, \
                record_calls(fused_bn, "channel_sums_pair", clone=True) as bwd, \
                record_ssim_levels() as levels:
            m = steps.adversarial(db["x"], db["y"], db["ref"], db["region"], db["item"],
                                  db["weight"], schedules.S_ADV_RSSS(0), schedules.D_ADV_RSSS(0))
            norms = {name: torch.sqrt(sum(p.grad.double().square().sum()
                                          for p in net.parameters()
                                          if p.grad is not None)).item()
                     for name, net in (("S", net_s), ("D", net_d))}
            step_stats = (_bn_stats(torch, net_s), _bn_stats(torch, net_d))
            if s_after is None:  # the card's updated S, for both test evaluations
                s_after = {name: p.detach().cpu().clone() for name, p in net_s.named_parameters()}
            with torch.no_grad():
                for name, p in net_s.named_parameters():
                    p.copy_(s_after[name])
            cm, _ = steps.eval_confusion_train(tb["x"], tb["y"], tb["ref"], tb["item"],
                                               tb["weight"])
        stats = (*step_stats, _bn_stats(torch, net_s), _bn_stats(torch, net_d))
        if dev == "cuda":  # the kernels on the calls' own inputs
            kernel_ratio = 0.0
            for (x,), got in fwd:
                xf = x.float().reshape(-1, x.shape[-1])
                for g, w, sc in zip(got, channel_sums_plain(x, True),
                                    (xf.abs().sum(0), xf.square().sum(0))):
                    kernel_ratio = max(kernel_ratio,
                                       ((g - w).abs() / (1e-5 * sc + 1e-30)).max().item())
            for (a, b), got in bwd:
                af, bf = a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1])
                for g, w, sc in zip(got, channel_sums_pair_plain(a, b),
                                    (af.abs().sum(0), (af * bf).abs().sum(0))):
                    kernel_ratio = max(kernel_ratio,
                                       ((g - w).abs() / (1e-5 * sc + 1e-30)).max().item())
            n_calls = (len(fwd), len(bwd))
            ssim_err = max((a - b).abs().max().item()
                           for x, y, (rng, win, sigma, kk), got in levels
                           for a, b in zip(got, ssim_level_plain(x, y, rng, win, sigma, *kk)))
            ssim_shapes = [list(x.shape) for x, *_ in levels]
        metrics = {key: float(v) for key, v in m.items() if key != "confusion"}
        res[dev] = (metrics, norms, stats, cm.cpu())
        del steps, db, tb, fwd, bwd, levels
    (mg, ng, sg, cg), (mc, nc, sc, cc) = res["cuda"], res["cpu"]
    loss_rel = max(abs(mg[key] - mc[key]) / max(abs(mc[key]), 1e-12) for key in mc)
    norm_rel = max(abs(ng[key] - nc[key]) / nc[key] for key in nc)
    stats_err = max((a - b).abs().max().item() for a, b in zip(sg, sc))
    want_calls = (2 * k["s_bns"] + 3 * k["d_bns"], k["s_bns"] + 3 * k["d_bns"])
    ok = (loss_rel <= 1e-4 and norm_rel <= 1e-3 and stats_err <= 1e-4
          and kernel_ratio <= 1.0 and n_calls == want_calls and ssim_err <= 2e-5
          and len(ssim_shapes) == 5 and all(sh[-1] == RSSS_BANDS for sh in ssim_shapes))
    phase("rsss_parity", {"tiles": items, "losses_cuda": mg, "losses_cpu": mc,
                          "grad_norms_cuda": ng, "grad_norms_cpu": nc,
                          "loss_max_rel": loss_rel, "grad_norm_max_rel": norm_rel,
                          "bn_stats_max_abs": stats_err,
                          "bn_stats_max_abs_by_call": {
                              f"{net} after the {call}": (a - b).abs().max().item()
                              for (call, net), a, b in zip(
                                  [(c, n) for c in ("step", "test evaluation") for n in "SD"],
                                  sg, sc)},
                          "bn_kernel_calls": n_calls,
                          "bn_kernel_calls_derived": want_calls,
                          "bn_kernel_err_over_tol": kernel_ratio,
                          "ssim_level_shapes": ssim_shapes,
                          "ssim_kernel_vs_plain_max_abs": ssim_err,
                          "test_confusion_cuda": cg.tolist(), "test_confusion_cpu": cc.tolist(),
                          "tols": {"loss_rel": 1e-4, "grad_norm_rel": 1e-3,
                                   "bn_stats_abs": 1e-4,
                                   "bn_kernel": "1e-5 * sum|x| per channel",
                                   "ssim_kernel_abs": 2e-5}, "ok": ok})
    if not ok:
        raise AssertionError(f"rsss parity: losses {loss_rel}, grad norms {norm_rel}, "
                             f"BN stats {stats_err}, BN kernels {kernel_ratio} x tol over "
                             f"{n_calls} calls (derived {want_calls}), SSIM {ssim_err} over "
                             f"{ssim_shapes}")


def serve_whu_phase(torch, root, wsss, siamese_stats="joint", modes=("train", "eval")):
    """tools.infer --mode whu over the wsss phase's 150 changed slices with
    its SModel, batch 15, S in ``siamese_stats`` mode: in bn_mode train (S's
    statistics per batch through channel_sums) the density images within
    one grey level of the demo's own train-mode inference (same batches,
    train-mode BN ignores the running buffers), then in eval mode; launches
    from the batches."""
    import numpy as np

    from fcdgan_tpu_torch.data.raster import read_image
    from fcdgan_tpu_torch.tools import infer

    dirs = dict(img_dir_x=os.path.join(root, "before"), img_dir_y=os.path.join(root, "after"),
                ref_dir=os.path.join(root, "Label"), label_dir=root)
    counters = kernel_counters()
    k = _model_counts(torch, WSSS_SIZE)
    sc, sb, sp, _ = _split_counts(k, siamese_stats == "split")
    batches = math.ceil(WSSS_SLICES[0] / WSSS_BATCH)
    res, checks, total = {}, {}, collections.Counter()
    for bn in modes:
        reset_launches(counters)
        out = infer.run(infer.InferConfig(
            mode="whu", smodel=wsss["smodel_path"], bn_mode=bn, batch_size=WSSS_BATCH,
            siamese_stats=siamese_stats, progress=False,
            outdir=os.path.join(root, f"serve_{siamese_stats}_{bn}"), **dirs))
        launches, variants = launch_counts(counters)
        total.update(launches)
        want = derived_serve_launches(counters, dict(k, s_convs=sc, s_pools=sp), batches)
        if bn == "train":
            want["channel_sums"] = sb * batches
        names = sorted(os.listdir(out["density_dir"]))
        r = {"slices_per_s": out["slices_per_s"], "seconds": out["seconds"],
             "launches": launches, "conv3x3_variants": variants, "derived_launches": want,
             **{key: out[key] for key in ("oa", "kappa", "f1", "miou")}}
        checks[f"{bn}_slices"] = out["slices"] == len(names) == WSSS_SLICES[0]
        checks[f"{bn}_launches"] = launches == want
        checks[f"{bn}_conv3x3_all_wgmma"] = all_wgmma(launches, variants)
        checks[f"{bn}_oa_miou_finite"] = all(math.isfinite(out[key]) for key in ("oa", "miou"))
        if bn == "train":
            levels = [np.abs(read_image(os.path.join(out["density_dir"], n)).astype(int)
                             - read_image(os.path.join(wsss["density_dir"], n)).astype(int))
                      for n in names]
            r["max_grey_level_diff_to_demo"] = int(max(lv.max() for lv in levels))
            r["byte_equal_to_demo"] = all(not lv.any() for lv in levels)
            checks["train_within_one_grey_level_of_demo"] = r["max_grey_level_diff_to_demo"] <= 1
        res[bn] = r
    name = "serve_whu" if siamese_stats == "joint" else "serve_whu_split"
    phase(name, {"slices": WSSS_SLICES[0], "batches": batches, "siamese_stats": siamese_stats,
                 **res, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"{name} checks failed: {checks}")
    return dict(total)


def serve_oscd_phase(torch, root, rsss):
    """tools.infer --mode oscd over all three OSCD scenes of the rsss phase
    with its SModel, bf16, batch 12 at FCDGAN_SERVE_BS=0 (the chunks of the
    demo's own inference): the fused per-scene path with two scenes in
    flight, twice; a density and a color raster per scene, the test scene's
    density within 1e-3 of the demo's, finite metrics, launches from the
    chunk plan."""
    import numpy as np

    from fcdgan_tpu_torch.data.device_cache import serve_chunks
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.tools import infer

    scenes = [s for group in RSSS_SCENES for s in group]
    with open(os.path.join(root, "all.txt"), "w") as f:
        f.write(",".join(scenes) + "\n")
    counters = kernel_counters()
    n_tiles = math.ceil(RSSS_SCENE / (RSSS_PATCH - 2 * PAD)) ** 2
    runs = []
    for _ in range(2):
        with environ(FCDGAN_SERVE_BS="0"):
            reset_launches(counters)
            out = infer.run(infer.InferConfig(
                mode="oscd", dir=root, txt_name="all.txt", smodel=rsss["smodel_path"],
                patch_size=(RSSS_PATCH, RSSS_PATCH), overlap_padding=(PAD, PAD),
                batch_size=RSSS_BATCH, progress=False))
            n_chunks = len(scenes) * len(serve_chunks(n_tiles, RSSS_BATCH))
        runs.append((out, *launch_counts(counters)))
    out, launches, variants = runs[0]
    want = derived_serve_launches(counters, _model_counts(torch, RSSS_PATCH, RSSS_BANDS), n_chunks)

    def raster(scene, name):
        return open_raster(os.path.join(root, scene, "ImagePair", name)).read_block()[..., 0]

    rasters_ok = True
    for scene in scenes:
        density, color = raster(scene, out["density_name"]), raster(scene, out["color_name"])
        rasters_ok &= bool(density.shape == color.shape == (RSSS_SCENE, RSSS_SCENE)
                           and np.isfinite(density).all()
                           and density.min() >= 0 and density.max() <= 1
                           and set(np.unique(color).tolist()) <= {0.0, 1.0, 2.0, 3.0})
    test = RSSS_SCENES[1][0]
    got, demo = raster(test, out["density_name"]), raster(test, rsss["density_name"])
    diff = float(np.abs(got - demo).max())
    checks = {"fused": out["fused"] and out["scenes"] == scenes, "rasters": rasters_ok,
              "test_scene_within_1e-3_of_demo": diff <= 1e-3,
              "metrics_finite": all(math.isfinite(out[key]) for key in ("oa", "kappa", "auc")),
              "launches": all(r[1] == want for r in runs),
              "conv3x3_all_wgmma": all(all_wgmma(r[1], r[2]) for r in runs)}
    phase("serve_oscd", {"scenes": scenes, "pixels": out["pixels"],
                         "px_per_s": [r[0]["px_per_s"] for r in runs],
                         "seconds": [r[0]["seconds"] for r in runs], "chunks": n_chunks,
                         "launches": launches, "conv3x3_variants": variants,
                         "derived_launches": want, "test_scene_max_abs_diff_to_demo": diff,
                         "test_scene_bit_equal_to_demo": bool(np.array_equal(got, demo)),
                         **{key: out[key] for key in ("oa", "kappa", "f1", "auc")},
                         "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve_oscd checks failed: {checks}")
    return launches, [r[0]["px_per_s"] for r in runs]


# -- the host and rolling-window feeds ---------------------------------------


def usss_args(work, ext, *extra):
    """demo_usss on the 2048² serve scene at the train phase's settings, one
    epoch of each phase."""
    return ["--dir", work, "--compute-dtype", "bfloat16", "--batch-size", str(BATCH),
            "--patch-size", f"{PATCH},{PATCH}", "--overlap-padding", f"{PAD},{PAD}",
            "--init-num-epochs-g", "1", "--init-num-epochs-s", "1", "--num-epochs", "1",
            "--log-tensorboard", "false", "--progress", "false", "--ext", ext, *extra]


def scene_dataset(work, scene, **kw):
    """The serve scene's ScenePairDataset with the normalizer of its stats
    caches (written by make_model)."""
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd

    scaler = Normalize(*dataset_meanstd(os.path.join(work, "T1_stats.txt"),
                                        os.path.join(work, "T2_stats.txt"), None))
    return ScenePairDataset(scene["x"], scene["y"], enhance=scaler, patch_size=(PATCH, PATCH),
                            overlap_padding=(PAD, PAD), **kw)


def within_ulp(got, want, ulps=1):
    """Whether two float32 arrays agree within ``ulps`` units in the last
    place, zeros where the other has zeros."""
    import numpy as np

    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    try:
        np.testing.assert_array_max_ulp(got, want, maxulp=ulps)
    except AssertionError:
        return False
    return bool(np.array_equal(got == 0, want == 0))


def window_plan(ds):
    """(slab sizes, steps an epoch and serving chunks at BATCH) of the
    window cache over ``ds`` at the current budget."""
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneWindowCache

    sizes = DeviceSceneWindowCache(ds, ds.enhance, "cpu").slab_sizes
    per = sum(-(-n // BATCH) for n in sizes)
    return sizes, per, per


def epoch_rates(sec):
    """Each phase's epochs/s from a driver's ``epoch_seconds``."""
    return {k: [1.0 / s for s in v] for k, v in sec.items() if k not in ("infer", "test")}


def waits_summary(waits):
    w = [row[2] for row in waits or []]
    return {"switches": len(w), "total_s": sum(w), "max_s": max(w, default=0.0), "each_s": w}


@contextlib.contextmanager
def first_step(cls, name):
    """Within the block, the float metrics of the first call of
    ``cls.name`` (a train step) go into the yielded dict."""
    got = {}
    with record_calls(cls, name) as calls:
        yield got
    if calls:
        got.update({k: float(v) for k, v in calls[0][1].items() if k != "confusion"})


@contextlib.contextmanager
def oscd_feed_timers(driver):
    """Within the block, where the time of ``NativeOSCDBatchLoader``'s
    batches goes: on its prefetch thread, each batch's whole production,
    the native assembler calls in it and the Python ref/region tile reads
    (``pipeline._paste``); on the driver's thread, the wait on each
    ``prefetch`` queue (one entry per epoch loop, in the driver's order).
    Yields the dict the totals go into."""
    from fcdgan_tpu_torch import native
    from fcdgan_tpu_torch.data import pipeline

    got = {"produce_s": [], "assemble_s": [], "paste_s": [], "loops": []}

    def timed(fn, key):
        @functools.wraps(fn)
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                got[key].append(time.perf_counter() - t0)
        return call

    def produce(loader_iter):
        @functools.wraps(loader_iter)
        def it(self):
            gen = loader_iter(self)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(gen)
                except StopIteration:
                    return
                got["produce_s"].append(time.perf_counter() - t0)
                yield batch
        return it

    def waited(fn):
        def run(iterator, depth=2):
            loop = {"batches": 0, "wait_s": 0.0, "t0": time.perf_counter()}
            got["loops"].append(loop)
            gen = fn(iterator, depth)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(gen)
                except StopIteration:
                    loop["seconds"] = time.perf_counter() - loop.pop("t0")
                    return
                loop["wait_s"] += time.perf_counter() - t0
                loop["batches"] += 1
                yield batch
        return run

    saved = [(native.NativePairAssembler, "assemble"), (pipeline, "_paste"),
             (pipeline.NativeOSCDBatchLoader, "__iter__"), (driver, "prefetch")]
    old = [getattr(o, n) for o, n in saved]
    native.NativePairAssembler.assemble = timed(old[0], "assemble_s")
    pipeline._paste = timed(old[1], "paste_s")
    pipeline.NativeOSCDBatchLoader.__iter__ = produce(old[2])
    driver.prefetch = waited(old[3])
    try:
        yield got
    finally:
        for (o, n), v in zip(saved, old):
            setattr(o, n, v)
    for key in ("produce_s", "assemble_s", "paste_s"):
        got[key] = {"calls": len(got[key]), "total_s": sum(got[key])}


def close_losses(a, b, rtol=1e-3):
    return bool(a) and a.keys() == b.keys() and all(
        math.isclose(a[k], b[k], rel_tol=rtol, abs_tol=1e-6) for k in a)


def usss_window_phase(torch, work, scene):
    """demo_usss on the 2048² scene with the scene resident and then through
    the rolling window (FCDGAN_SCENE_WINDOW_MB giving 4 slabs), one epoch of
    each phase each; then the window's tiles against the resident gather
    over an epoch, and the trained S's windowed densities (canvas and per
    slab, float32 and uint8, each SERVE_REPEATS times) against its resident
    one."""
    import numpy as np

    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache, DeviceSceneWindowCache
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.demos import demo_usss

    counters = kernel_counters()
    runs = {}
    with environ(FCDGAN_SCENE_WINDOW_MB=WINDOW_MB, FCDGAN_SERVE_BS=None):
        ds = scene_dataset(work, scene, ref_path=scene["ref"])
        sizes, steps, chunks = window_plan(ds)
        for cache in ("on", "window"):
            reset_launches(counters)
            t0 = time.perf_counter()
            with step_calls() as seen:
                out = demo_usss.main(usss_args(work, f"_{cache}", "--scene-cache", cache))
            runs[cache] = (out, time.perf_counter() - t0, *launch_counts(counters), seen)
        n = runs["on"][0]["tiles"]
        want_launches = {"on": derived_launches(torch, n, (1, 1, 1), seen=runs["on"][4])[0],
                         "window": derived_launches(torch, n, (1, 1, 1), steps, chunks,
                                                    seen=runs["window"][4])[0]}
        win = DeviceSceneWindowCache(ds, ds.enhance, "cuda")
        resident = DeviceSceneCache(ds, ds.enhance, "cuda")
        seen, tiles_equal = [], True
        for batch in win.loader(BATCH, shuffle=True, seed=5):
            a, b = win.complete(batch), resident.complete(batch)
            tiles_equal &= all(torch.equal(a[k], b[k]) for k in ("x", "y", "ref"))
            seen += [int(i) for i, w in zip(batch["item"], batch["weight"]) if w > 0]
        net = runs["window"][0]["sstate"].eval()
        want = {dd: resident.stitched_density(net, BATCH, dd) for dd in ("float32", "uint8")}
        written = open_raster(runs["window"][0]["density_path"]).read_block()[..., 0]
        serve = {}
        for tag, dd, env in (("canvas", "float32", {}),
                             ("slabs", "float32", {"FCDGAN_SERVE_CANVAS_MAX_MB": "1"}),
                             ("canvas_uint8", "uint8", {})):
            rates, equal = [], True
            for _ in range(SERVE_REPEATS):  # the run-to-run spread of each path
                with environ(**env):
                    cache = DeviceSceneWindowCache(ds, ds.enhance, "cuda")
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = cache.stitched_density(net, BATCH, dd)
                    rates.append(got.size / (time.perf_counter() - t0))
                equal &= bool(np.array_equal(got, want[dd]))
            serve[tag] = {"bit_equal_to_resident": equal, "px_per_s": rates,
                          "slab_waits": waits_summary(cache.slab_waits)}
    out_w = runs["window"][0]
    checks = {
        "feeds": [runs[c][0]["feed"] for c in ("on", "window")] == ["resident", "window"],
        "n_slabs_at_least_4": out_w["n_slabs"] == len(sizes) >= 4,
        "tiles_bit_equal_to_resident": bool(tiles_equal),
        "every_tile_once_an_epoch": sorted(seen) == list(range(n)),
        "written_density_is_resident_of_its_s": bool(np.array_equal(written, want["float32"])),
        "launches": all(runs[c][2] == want_launches[c] for c in runs),
        "conv3x3_all_wgmma": all(all_wgmma(runs[c][2], runs[c][3]) for c in runs),
        "losses_finite": all(math.isfinite(v) for c in runs for ph in
                             runs[c][0]["epoch_metrics"].values() for m in ph for v in m.values()),
        **{f"density_{tag}_bit_equal": r["bit_equal_to_resident"] for tag, r in serve.items()},
    }
    phase("usss_window", {
        "feed": out_w["feed"], "window_mb": WINDOW_MB, "n_slabs": out_w["n_slabs"],
        "slab_sizes": sizes, "steps_per_epoch": {"resident": -(-n // BATCH), "window": steps},
        "slab_waits": waits_summary(out_w["slab_waits"]),
        "epochs_per_s": {c: epoch_rates(runs[c][0]["epoch_seconds"]) for c in runs},
        "seconds": {c: runs[c][1] for c in runs},
        "inference_seconds": {c: runs[c][0]["epoch_seconds"]["infer"] for c in runs},
        "launches": runs["window"][2], "derived_launches": want_launches["window"],
        "conv3x3_variants": runs["window"][3], "serve": serve,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"usss_window checks failed: {checks}")
    return runs["window"][2]


def usss_host_phase(torch, work, scene):
    """demo_usss on the 2048² scene with --scene-cache off: the native raw
    tiles normalized on the card, one epoch of each phase, then the tile-loop
    inference; the feed's tiles (and those of --device-normalize off) within
    1 f32 ulp of the resident gather."""
    import numpy as np

    from fcdgan_tpu_torch.config import USSSConfig
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.data.pipeline import device_put_batch
    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.demos import demo_usss

    counters = kernel_counters()
    reset_launches(counters)
    t0 = time.perf_counter()
    with step_calls() as seen:
        out = demo_usss.main(usss_args(work, "_host", "--scene-cache", "off"))
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    n = out["tiles"]
    want = derived_launches(torch, n, (1, 1, 1), chunks=-(-n // BATCH), seen=seen)[0]
    ds = scene_dataset(work, scene, ref_path=scene["ref"])
    resident = DeviceSceneCache(ds, ds.enhance, "cuda")
    feeds, tiles_ok = {}, True
    for dn in ("auto", "off"):
        cfg = USSSConfig(dir=work, batch_size=BATCH, scene_cache="off", device_normalize=dn)
        feed, _, loader, placer = demo_usss.scene_feed(cfg, ds, ds.enhance, "cuda")
        feeds[dn] = feed
        for k, batch in zip(range(3), loader):
            db = device_put_batch(batch, "cuda")
            db = placer(db) if placer is not None else db
            ref = resident.complete(batch)
            tiles_ok &= all(within_ulp(db[key].cpu().numpy(), ref[key].cpu().numpy())
                            for key in ("x", "y"))
            tiles_ok &= bool(torch.equal(db["ref"].float(), ref["ref"]))
    density = open_raster(out["density_path"]).read_block()[..., 0]
    checks = {
        "feed_native_raw": out["feed"] == "native_raw",
        "device_normalize_off_takes_native": feeds == {"auto": "native_raw", "off": "native"},
        "tiles_within_1_ulp_of_resident": bool(tiles_ok),
        "tile_loop_density_written": bool(density.shape == (SCENE, SCENE)
                                          and np.isfinite(density).all()
                                          and 0 <= density.min() <= density.max() <= 1),
        "color_written": os.path.isfile(out["color_path"]),
        "launches": launches == want, "conv3x3_all_wgmma": all_wgmma(launches, variants),
        "losses_finite": all(math.isfinite(v) for ph in out["epoch_metrics"].values()
                             for m in ph for v in m.values()),
    }
    phase("usss_host", {"feed": out["feed"], "seconds": seconds,
                        "epochs_per_s": epoch_rates(out["epoch_seconds"]),
                        "inference_seconds": out["epoch_seconds"]["infer"],
                        "launches": launches, "derived_launches": want,
                        "conv3x3_variants": variants, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"usss_host checks failed: {checks}")
    return launches


def serve_window_phase(torch, work, scene, smodel):
    """stitched_inference(device_feed='auto') on the 2048² scene with
    FCDGAN_SCENE_CACHE_MAX_MB below it: the window feed, its density bit-equal
    to the resident fused pass at the same chunks; twice each, px/s."""
    import numpy as np

    from fcdgan_tpu_torch.eval.inference import stitched_inference
    from fcdgan_tpu_torch.io.checkpoint import load_segmentor

    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache, serve_chunks

    net = load_segmentor(smodel, device="cuda", compute_dtype=torch.bfloat16)
    counters = kernel_counters()
    res = {}
    half = str(DeviceSceneCache.scene_bytes(scene_dataset(work, scene)) / 2e6)  # MB
    with environ(FCDGAN_SERVE_BS="0", FCDGAN_SCENE_WINDOW_MB=WINDOW_MB):
        for budget in (None, half, half, None):
            with environ(FCDGAN_SCENE_CACHE_MAX_MB=budget):
                tag = "resident" if budget is None else "window"
                ds = scene_dataset(work, scene, out_path=os.path.join(work, f"d_{tag}.tif"))
                sizes, _, chunks = window_plan(ds)
                reset_launches(counters)
                out = stitched_inference(ds, net, BATCH, "cuda")
                launches, variants = launch_counts(counters)
            r = res.setdefault(tag, {"px_per_s": [], "feed": [], "launches": launches,
                                     "conv3x3_variants": variants})
            r["px_per_s"].append(out["px_per_s"])
            r["feed"].append(out["feed"])
            r["density"] = out["density"]
    k = _model_counts(torch, PATCH)
    want = {"resident": derived_serve_launches(counters, k, len(serve_chunks(len(ds), BATCH))),
            "window": derived_serve_launches(counters, k, chunks)}
    checks = {"feeds": res["window"]["feed"] == ["window"] * 2
              and res["resident"]["feed"] == ["resident"] * 2,
              "bit_equal_to_resident": bool(np.array_equal(res["window"]["density"],
                                                           res["resident"]["density"])),
              **{f"launches_{t}": res[t]["launches"] == want[t] for t in res},
              **{f"conv3x3_all_wgmma_{t}": all_wgmma(res[t]["launches"],
                                                      res[t]["conv3x3_variants"]) for t in res}}
    phase("serve_window", {"pixels": SCENE * SCENE, "slab_sizes": sizes,
                           **{t: {key: v for key, v in r.items() if key != "density"}
                              for t, r in res.items()},
                           "derived_launches": want, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve_window checks failed: {checks}")
    return res["window"]["launches"]


def wsss_host_phase(torch, root, wsss):
    """demo_wsss with --slice-cache off over the wsss phase's slices (a G
    model of its own, so the G pretrain runs): the native slice loaders,
    1 G-pretrain + 2 adversarial epochs, the first G-pretrain step's losses
    within rtol 1e-3 of the resident run's; the feed's batches item for item
    and within 1 f32 ulp of the resident cache's under the same seed."""
    import random

    import numpy as np

    from fcdgan_tpu_torch.config import WSSSConfig
    from fcdgan_tpu_torch.data.datasets import WHUPairDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.pipeline import device_put_batch
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.demos import demo_wsss
    from fcdgan_tpu_torch.train.steps import WSSSSteps

    dirs = [os.path.join(root, d) for d in ("before", "after", "Label")] + [root]
    argv = ["--img-dir-x", dirs[0], "--img-dir-y", dirs[1], "--ref-dir", dirs[2],
            "--label-dir", root, "--out-g-model-dir", os.path.join(root, "GModel_host"),
            "--compute-dtype", "bfloat16", "--batch-size", str(WSSS_BATCH),
            "--unc-batch-size", str(WSSS_UNC_BATCH), "--perception-layer", "1",
            "--init-num-epochs-g", "1", "--num-epochs", "2", "--slice-cache", "off",
            "--log-tensorboard", "false", "--progress", "false", "--ext", "_host"]
    counters = kernel_counters()
    reset_launches(counters)
    t0 = time.perf_counter()
    with first_step(WSSSSteps, "g_pretrain") as first, step_calls() as seen:
        out = demo_wsss.main(argv)
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    want = derived_wsss_launches(torch, (1, 2), seen=seen)[0]
    scaler = Normalize(*dataset_meanstd(os.path.join(dirs[0], "stats_meanstd.txt"),
                                        os.path.join(dirs[1], "stats_meanstd.txt"), None))
    same_items, tiles_ok, batches = True, True, 0
    feeds = {}
    loaders = {}
    for sc in ("on", "off"):
        cfg = WSSSConfig(img_dir_x=dirs[0], img_dir_y=dirs[1], ref_dir=dirs[2], label_dir=root,
                         batch_size=WSSS_BATCH, unc_batch_size=WSSS_UNC_BATCH, slice_cache=sc)
        pair = WHUPairDataset(*dirs, scale=scaler, rng=random.Random(0))
        feeds[sc], _, cache, pl, ul = demo_wsss.slice_feed(cfg, pair, scaler, "cuda")
        loaders[sc] = (cache, list(pl), list(ul))
    cache = loaders["on"][0]

    def real(b, n):  # a wrap-padded tail's real entries (the resident tail is short)
        return {k: np.asarray(v)[:n] for k, v in b.items()}

    for rb, nb in zip(loaders["on"][1], loaders["off"][1]):
        nb = real(nb, len(rb["weight"]))
        same_items &= all(np.array_equal(rb[k], nb[k]) for k in ("c_item", "nc_item", "weight"))
        got = device_put_batch({k: nb[k] for k in ("c_x", "c_y", "nc_x", "nc_y", "c_ref")},
                               "cuda")
        ref = cache.complete_pair(rb)
        tiles_ok &= all(within_ulp(got[k].cpu().numpy(), ref[k].cpu().numpy())
                        for k in ("c_x", "c_y", "nc_x", "nc_y"))
        tiles_ok &= bool(torch.equal(got["c_ref"], ref["c_ref"]))
        batches += 1
    for rb, nb in zip(loaders["on"][2], loaders["off"][2]):
        nb = real(nb, len(rb["weight"]))
        same_items &= bool(np.array_equal(rb["item"], nb["item"]))
        ref = cache.complete_unc(rb)
        got = device_put_batch({k: nb[k] for k in ("x", "y")}, "cuda")
        tiles_ok &= all(within_ulp(got[k].cpu().numpy(), ref[k].cpu().numpy()) for k in ("x", "y"))
    sec, res_sec = out["epoch_seconds"], wsss["epoch_seconds"]
    checks = {
        "feeds": out["feed"] == "native" and feeds == {"on": "resident", "off": "native"},
        "batches_item_for_item": bool(same_items) and batches == len(loaders["off"][1]) > 0,
        "tiles_within_1_ulp_of_resident": bool(tiles_ok),
        "first_g_step_losses_rtol_1e-3": close_losses(first, wsss["first_g_step"]),
        "confusion_covers_changed": bool(
            out["evaluator"].confusion_matrix.sum() == WSSS_SLICES[0] * WSSS_SIZE ** 2),
        "launches": launches == want, "conv3x3_all_wgmma": all_wgmma(launches, variants),
    }
    phase("wsss_host", {"feed": out["feed"], "seconds": seconds,
                        "g_epoch_seconds": sec["g"], "adv_epoch_seconds": sec["adv"],
                        "adv_epochs_per_s_warm": 1.0 / sec["adv"][-1],
                        "resident_adv_epochs_per_s_warm": len(res_sec["adv"][1:])
                        / sum(res_sec["adv"][1:]),
                        "inference_seconds": sec["infer"],
                        "first_g_step": first, "resident_first_g_step": wsss["first_g_step"],
                        "launches": launches, "derived_launches": want,
                        "conv3x3_variants": variants, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"wsss_host checks failed: {checks}")
    return launches


def rsss_host_phase(torch, root, rsss):
    """demo_rsss with --tile-cache off over the rsss phase's scenes (a G model
    of its own): NativeOSCDBatchLoader with padded tails, 1 G-pretrain + 2
    adversarial epochs with their test evaluations and the inference, the
    first G-pretrain step's losses within rtol 1e-3 of the resident run's."""
    from fcdgan_tpu_torch.demos import demo_rsss
    from fcdgan_tpu_torch.train.steps import RSSSSteps

    argv = ["--img-dir", root, "--out-g-model-dir", os.path.join(root, "GModel_host"),
            "--compute-dtype", "bfloat16", "--init-batch-size", str(RSSS_INIT_BATCH),
            "--batch-size", str(RSSS_BATCH), "--patch-size", f"{RSSS_PATCH},{RSSS_PATCH}",
            "--init-num-epochs-g", "1", "--num-epochs", "2", "--tile-cache", "off",
            "--log-tensorboard", "false", "--progress", "false", "--ext", "_host"]
    counters = kernel_counters()
    reset_launches(counters)
    t0 = time.perf_counter()
    with first_step(RSSSSteps, "g_pretrain") as first, oscd_feed_timers(demo_rsss) as feed:
        out = demo_rsss.main(argv)
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    n_train, n_test = out["tiles"], out["test_tiles"]
    # the driver's loops in order: G pretrain, (adversarial, test) per epoch, inference
    loop_names = ["g"] + ["adv", "test"] * 2 + ["infer"]
    want = derived_rsss_launches(torch, n_train, n_test, (1, 2))[0]
    sec, res_sec = out["epoch_seconds"], rsss["epoch_seconds"]
    test_px = len(RSSS_SCENES[1]) * RSSS_SCENE ** 2
    checks = {
        "feed_native": out["feed"] == "native",
        "padded_tails": n_train % RSSS_INIT_BATCH != 0,
        "epochs": [len(sec["g"]), len(sec["adv"]), len(sec["test"])] == [1, 2, 2],
        "test_and_inference_cover_the_test_scene": bool(
            out["evaluator"].confusion_matrix.sum() == test_px
            == out["test_evaluator"].confusion_matrix.sum()),
        "first_g_step_losses_rtol_1e-3": close_losses(first, rsss["first_g_step"]),
        "feed_timed": len(feed["loops"]) == len(loop_names) and feed["assemble_s"]["calls"] > 0,
        "losses_finite": all(math.isfinite(v) for ph in out["epoch_metrics"].values()
                             for m in ph for key, v in m.items() if key != "f1"),
        "launches": launches == want, "conv3x3_all_wgmma": all_wgmma(launches, variants),
    }
    phase("rsss_host", {"feed": out["feed"], "seconds": seconds,
                        "g_epoch_seconds": sec["g"], "adv_epoch_seconds": sec["adv"],
                        "test_eval_seconds": sec["test"],
                        "adv_epochs_per_s_warm": 1.0 / sec["adv"][-1],
                        "resident_adv_epochs_per_s_warm": len(res_sec["adv"][1:])
                        / sum(res_sec["adv"][1:]),
                        "inference_seconds": sec["infer"],
                        "feed_time": {**{k: feed[k] for k in
                                         ("produce_s", "assemble_s", "paste_s")},
                                      "loops": [{"loop": name, **loop} for name, loop
                                                in zip(loop_names, feed["loops"])]},
                        "first_g_step": first, "resident_first_g_step": rsss["first_g_step"],
                        "launches": launches, "derived_launches": want,
                        "conv3x3_variants": variants, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"rsss_host checks failed: {checks}")
    return launches


def serve_oscd_stream_phase(torch, root, rsss, fused_px_per_s):
    """tools.infer --mode oscd --device-feed stream over the three scenes of
    the rsss phase (NativeOSCDBatchLoader, its tail wrap-padded), twice: each
    scene's density within one bf16 step (2^-8) of the serve_oscd phase's
    fused one; launches from the batches; px/s against the fused path's."""
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.tools import infer

    scenes = [s for group in RSSS_SCENES for s in group]
    counters = kernel_counters()
    n_tiles = len(scenes) * math.ceil(RSSS_SCENE / (RSSS_PATCH - 2 * PAD)) ** 2
    batches = -(-n_tiles // RSSS_BATCH)
    want = derived_serve_launches(counters, _model_counts(torch, RSSS_PATCH, RSSS_BANDS),
                                  batches)
    runs = []
    for _ in range(2):
        reset_launches(counters)
        out = infer.run(infer.InferConfig(
            mode="oscd", dir=root, txt_name="all.txt", smodel=rsss["smodel_path"],
            patch_size=(RSSS_PATCH, RSSS_PATCH), overlap_padding=(PAD, PAD),
            batch_size=RSSS_BATCH, device_feed="stream", ext="_stream", progress=False))
        runs.append((out, *launch_counts(counters)))
    out = runs[0][0]

    def raster(scene, name):
        return open_raster(os.path.join(root, scene, "ImagePair", name)).read_block()[..., 0]

    diffs = [float(np.abs(raster(s, out["density_name"]) - raster(s, "density_serve")).max())
             for s in scenes]
    checks = {"feed_native": all(r[0]["feed"] == "native" and not r[0]["fused"] for r in runs),
              "within_one_bf16_step_of_fused": max(diffs) <= BF16_STEP,
              "pixels": out["pixels"] == len(scenes) * RSSS_SCENE ** 2,
              "metrics_finite": all(math.isfinite(out[key]) for key in ("oa", "kappa", "auc")),
              "launches": all(r[1] == want for r in runs),
              "conv3x3_all_wgmma": all(all_wgmma(r[1], r[2]) for r in runs)}
    phase("serve_oscd_stream", {"feed": out["feed"], "scenes": scenes, "batches": batches,
                                "px_per_s": [r[0]["px_per_s"] for r in runs],
                                "fused_px_per_s": fused_px_per_s,
                                "max_abs_diff_to_fused": diffs, "tol": BF16_STEP,
                                "launches": runs[0][1], "derived_launches": want,
                                "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve_oscd_stream checks failed: {checks}")
    return runs[0][1]


SPLIT_EPOCHS = (1, 1, 1)  # usss_split: G pretrain, S init, joint
REMAT_STEPS = 10  # remat: timed joint steps of each run, after one warm step
KERNEL_SYMBOLS = {"conv3x3": "conv3x3_wgmma_kernel", "pool_bwd": "pool_bwd_nhwc_kernel",
                  "fused_ssim": "ssim_level_kernel", "channel_sums": "channel_sums_kernel",
                  "phase_pool": "phase_pool_nhwc_kernel"}


def _driver_checks(out, launches, variants, want, losses):
    return {"losses_finite": bool(losses) and all(math.isfinite(v) for v in losses),
            "launches": launches == want, "conv3x3_all_wgmma": all_wgmma(launches, variants)}


def usss_split_phase(torch, tdir, joint):
    """demos.demo_usss with --siamese-stats split on the train phase's scene
    and settings, 1 + 1 + 1 epochs and the fused inference: every artifact,
    finite losses, density in [0, 1], each kernel's launches equal to the
    count derived from the split model (S's encoder once per branch, in the
    inference too), all conv3x3 on wgmma; the joint epoch's rate beside the
    joint run's (the train phase, same call)."""
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.demos import demo_usss

    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    t0 = time.perf_counter()
    with step_calls() as seen:
        out = demo_usss.main(train_args(tdir, "_split", SPLIT_EPOCHS, "--siamese-stats",
                                        "split"))
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    want, per_step = derived_launches(torch, out["tiles"], SPLIT_EPOCHS, split=True,
                                      seen=seen)
    density = open_raster(out["density_path"]).read_block()[..., 0]
    sec, jsec = out["epoch_seconds"], joint["epoch_seconds"]
    losses = [v for ph in out["epoch_metrics"].values() for m in ph for v in m.values()]
    checks = {
        "split": out["sstate"].siamese_stats == "split",
        "artifacts": all(os.path.isfile(out[k]) for k in (
            "density_path", "color_path", "para_path", "smodel_path", "gmodel_path")),
        "epochs": [len(sec[p]) for p in ("g", "s", "joint")] == list(SPLIT_EPOCHS),
        "density_in_0_1": bool(np.isfinite(density).all() and density.min() >= 0
                               and density.max() <= 1),
        **_driver_checks(out, launches, variants, want, losses)}
    phase("usss_split", {
        "seconds": seconds, "tiles": out["tiles"],
        "epoch_seconds": {p: sec[p] for p in ("g", "s", "joint")},
        "joint_epochs_per_s": 1.0 / sec["joint"][0],
        "joint_mode_joint_epochs_per_s": {"first": 1.0 / jsec["joint"][0],
                                          "warm": len(jsec["joint"][1:]) / sum(jsec["joint"][1:])},
        "s_init_epochs_per_s": 1.0 / sec["s"][0],
        "joint_mode_s_init_epochs_per_s": 1.0 / jsec["s"][0],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "derived_launches": want, "per_step": per_step,
        "oa": float(out["evaluator"].Pixel_Accuracy()), "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"usss_split checks failed: {checks}")
    return launches


def remat_phase(torch, tdir):
    """USSS joint steps on 10 tiles of the train phase's scene (full-width G
    and S) with and without remat, from the same seeded weights: after one
    step every BN's running statistics and counts of G and S (f32 within
    1e-6, bf16 within 1e-4, the step-parity tolerance; counts exactly) and
    the losses (relative, the same bounds); each step's launches against the
    derived count (a remat step launches the forward kernels of G, S and
    the loss stack's VGG pools again: its MS-SSIM, computed last without a
    graph, is not recomputed); then, in bf16, the step ms over REMAT_STEPS
    steps after a warm one and the peak device memory of each, in turns
    (without, with, with, without)."""
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
    from fcdgan_tpu_torch.train.optim import adam
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

    scaler = Normalize(*dataset_meanstd(os.path.join(tdir, "T1_stats.txt"),
                                        os.path.join(tdir, "T2_stats.txt"), None))
    ds = ScenePairDataset(os.path.join(tdir, "T1.tif"), os.path.join(tdir, "T2.tif"),
                          ref_path=os.path.join(tdir, "ref.tif"), enhance=scaler,
                          patch_size=(PATCH, PATCH), overlap_padding=(PAD, PAD))
    cache = DeviceSceneCache(ds, scaler, "cuda")
    db = cache.complete({"item": list(range(BATCH)), "weight": [1.0] * BATCH})
    args = (db["x"], db["y"], db["ref"], db["item"], db["weight"], 1e-4, 1e-4)
    torch.manual_seed(0)
    nets0 = (Generator(3), Segmentor(3))
    vgg = VGG16Weights(vgg16_random_params(0), "cuda")
    counters = kernel_counters()
    k = _model_counts(torch, PATCH)
    _, per_step = derived_launches(torch, BATCH)
    plain = {name: kinds.get("joint", 0) for name, kinds in per_step.items()}
    again = {"conv3x3": k["g_convs"] + k["s_convs"], "channel_sums": k["g_bns"] + k["s_bns"],
             "phase_pool": k["s_pools"] + k["vgg_pools"]}

    def make(dtype, remat):
        net_g, net_s = (type(n)(3, compute_dtype=dtype) for n in nets0)
        for a, b in zip((net_g, net_s), nets0):
            a.load_state_dict(b.state_dict())
            a.cuda()
        return USSSSteps(net_g, net_s, adam(net_g.parameters()), adam(net_s.parameters()), vgg,
                         PerceptionConfig((29,), True,
                                          dtype if dtype == torch.bfloat16 else None),
                         0.4, 0.65, 0.0, ds.grid.interior_sizes(), (PAD, PAD), remat=remat)

    runs, checks, launches_out = {}, {}, None
    for dt_name, tol in (("float32", 1e-6), ("bfloat16", 1e-4)):
        dtype = getattr(torch, dt_name)
        res = {}
        for remat in (False, True):
            steps = make(dtype, remat)
            reset_launches(counters)
            with step_calls() as seen:
                m = steps.joint(*args)
            torch.cuda.synchronize()
            launches, _ = launch_counts(counters)
            passes = host_steps(1, seen)  # eager, and without remat its capture
            want = {n: passes * plain[n] + (again.get(n, 0) if remat else 0) for n in plain}
            checks[f"{dt_name}_{'remat' if remat else 'plain'}_launches"] = launches == want
            if remat and dt_name == "bfloat16":
                launches_out = launches
            bufs = {f"{name}.{b}": v.detach().float().cpu()
                    for name, net in (("G", steps.G), ("S", steps.S))
                    for b, v in net.named_buffers()}
            res[remat] = ({key: float(v) for key, v in m.items() if key != "confusion"},
                          bufs, launches, want)
            del steps, m
            gc.collect()
        (m0, b0, l0, w0), (m1, b1, l1, w1) = res[False], res[True]
        stat_err = max((b1[key] - v).abs().max().item() for key, v in b0.items()
                       if not key.endswith("num_batches_tracked"))
        counts_equal = all(int(b1[key]) == int(v) == 1 for key, v in b0.items()
                           if key.endswith("num_batches_tracked"))
        loss_rel = max(abs(m1[key] - m0[key]) / max(abs(m0[key]), 1e-12) for key in m0)
        checks[f"{dt_name}_bn_stats"] = stat_err <= tol
        checks[f"{dt_name}_counts_once"] = counts_equal
        checks[f"{dt_name}_losses"] = loss_rel <= tol
        runs[dt_name] = {"bn_stats_max_abs": stat_err, "loss_max_rel": loss_rel, "tol": tol,
                         "launches_plain": l0, "launches_remat": l1,
                         "derived_plain": w0, "derived_remat": w1}
    timing = collections.defaultdict(list)
    for remat in (False, True, True, False):
        steps = make(torch.bfloat16, remat)
        steps.joint(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(REMAT_STEPS):
            steps.joint(*args)
        torch.cuda.synchronize()
        key = "remat" if remat else "plain"
        timing[f"{key}_step_ms"].append((time.perf_counter() - t0) / REMAT_STEPS * 1e3)
        timing[f"{key}_peak_mem_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        del steps
        gc.collect()
    phase("remat", {"tiles": BATCH, **runs, **timing, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"remat checks failed: {checks}")
    return launches_out


def replay_phase(torch, tdir):
    """The USSS joint step and the WSSS adversarial step on the card as CUDA
    graphs, their replays counted on the device: the joint step at the
    train phase's settings (bf16, full-width G and S, per-band perception at
    relu5_3) on BATCH tiles of its scene and on a 1-tile tail, the
    adversarial step at the wsss phase's (``tools.bench.wsss_setup``: bf16,
    15 pairs of 200 px, RGB perception at layer 1). Each shape's first call
    is its eager step and its capture, which the kernel wrappers count
    twice; then three replays under torch.profiler, each of which launches
    every kernel, by its symbol, as often as the step's derived count says
    (``derived_launches``, ``derived_wsss_launches``; channel_sums and
    channel_sums_pair share one symbol), while the wrappers count none."""
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
    from fcdgan_tpu_torch.tools import bench
    from fcdgan_tpu_torch.train.optim import adam
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

    counters = kernel_counters()
    res, checks = {}, {}

    def replays(name, call, per_kind):
        """``call``'s first call and three replays; ``per_kind``: each
        kernel's derived launches in one step."""
        want = {k: per_kind[k] for k in KERNEL_SYMBOLS}
        want["channel_sums"] += per_kind["channel_sums_pair"]
        reset_launches(counters)
        with step_calls() as seen:
            call()
            first, _ = launch_counts(counters)
            launched = device_launches(torch, call)
            replayed, _ = launch_counts(counters)
        got = [{k: sum(sym in n for n in names) for k, sym in KERNEL_SYMBOLS.items()}
               for names in launched]
        res[name] = {"device_launches_per_replay": got, "derived": want,
                     "host_launches_first_call": first, "step_calls": dict(seen)}
        checks[f"{name}_replays_launch_the_derived"] = all(g == want for g in got)
        checks[f"{name}_first_call_counts_twice"] = first == {k: 2 * v
                                                             for k, v in per_kind.items()}
        checks[f"{name}_replays_not_counted_on_the_host"] = replayed == first
        checks[f"{name}_calls"] = dict(seen) == {"step.eager": 1, "step.graph_captures": 1,
                                                 "step.graph_replays": 4}

    scaler = Normalize(*dataset_meanstd(os.path.join(tdir, "T1_stats.txt"),
                                        os.path.join(tdir, "T2_stats.txt"), None))
    ds = ScenePairDataset(os.path.join(tdir, "T1.tif"), os.path.join(tdir, "T2.tif"),
                          ref_path=os.path.join(tdir, "ref.tif"), enhance=scaler,
                          patch_size=(PATCH, PATCH), overlap_padding=(PAD, PAD))
    cache = DeviceSceneCache(ds, scaler, "cuda")
    torch.manual_seed(0)
    net_g = Generator(3, compute_dtype=torch.bfloat16).cuda()
    net_s = Segmentor(3, compute_dtype=torch.bfloat16).cuda()
    steps = USSSSteps(net_g, net_s, adam(net_g.parameters()), adam(net_s.parameters()),
                      VGG16Weights(vgg16_random_params(0), "cuda"),
                      PerceptionConfig((29,), True, torch.bfloat16),
                      0.4, 0.65, 0.0, ds.grid.interior_sizes(), (PAD, PAD))
    _, per_step = derived_launches(torch, BATCH)
    joint = {k: kinds.get("joint", 0) for k, kinds in per_step.items()}
    for n in (BATCH, 1):
        db = cache.complete({"item": list(range(n)), "weight": [1.0] * n})
        args = (db["x"], db["y"], db["ref"], db["item"], db["weight"], 1e-4, 1e-4)
        replays(f"tiles{n}", lambda: steps.joint(*args), joint)
    del steps, cache, db, args
    torch.cuda.empty_cache()
    _, per_step = derived_wsss_launches(torch)
    adv, args = bench.wsss_setup(torch.device("cuda", 0))
    replays("adversarial", lambda: adv.adversarial(*args),
            {k: kinds.get("adversarial", 0) for k, kinds in per_step.items()})
    del adv, args
    torch.cuda.empty_cache()
    phase("replay", {**res, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"replay checks failed: {checks}")


def resume_phase(torch, tdir):
    """demos.demo_usss on the train phase's scene with --checkpoint-every 1,
    stopped after the S-init phase (1 + 1 + 0 epochs), then run again with
    --resume and one joint epoch: the G pretrain and S init are skipped, the
    restored state_dicts of S and G (parameters, BN buffers) and their Adam
    states equal the saved files bit for bit, the resumed run's launches are
    those of one joint epoch and the inference; the seconds of each save."""
    import copy

    from fcdgan_tpu_torch.demos import demo_usss
    from fcdgan_tpu_torch.io.checkpoint import TrainCheckpointer

    save_s, restored = [], {}
    orig_save, orig_restore = TrainCheckpointer.maybe_save, TrainCheckpointer.restore

    def timed_save(self, phase_name, epoch, **nets):
        t0 = time.perf_counter()
        if orig_save(self, phase_name, epoch, **nets):
            save_s.append({"phase": phase_name, "nets": sorted(nets),
                           "seconds": time.perf_counter() - t0})
            return True
        return False

    def captured(self, nets):
        meta = orig_restore(self, nets)
        for name, (module, opt) in nets.items():
            restored[name] = copy.deepcopy(
                ({key: v.cpu() for key, v in module.state_dict().items()},
                 opt.state_dict()))
        return meta

    counters = kernel_counters()
    TrainCheckpointer.maybe_save, TrainCheckpointer.restore = timed_save, captured
    try:
        first = demo_usss.main(train_args(tdir, "_resume", (1, 1, 0), "--checkpoint-every", "1",
                                          "--save-checkpoints", "false"))
        ckdir = os.path.join(tdir, "resume_resume.ckpt")
        saved = {name: torch.load(os.path.join(ckdir, f"{name}.pt"), map_location="cpu",
                                  weights_only=True) for name in ("netG", "netS")}
        with open(os.path.join(ckdir, "meta.json")) as f:
            meta = json.load(f)
        reset_launches(counters)
        with step_calls() as seen:
            second = demo_usss.main(train_args(tdir, "_resume", (1, 1, 1), "--resume", "true",
                                               "--save-checkpoints", "false"))
        launches, variants = launch_counts(counters)
    finally:
        TrainCheckpointer.maybe_save, TrainCheckpointer.restore = orig_save, orig_restore
    want, _ = derived_launches(torch, second["tiles"], (0, 0, 1), seen=seen)

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[key], b[key]) for key in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if hasattr(a, "dtype"):
            return torch.equal(a.cpu(), b.cpu())
        return a == b

    bit_equal = {name: same(restored[name][0], saved[name]["state_dict"])
                 and same(restored[name][1], saved[name]["optimizer"]) for name in saved}
    sec = second["epoch_seconds"]
    checks = {
        "first_run_epochs": [len(first["epoch_seconds"][p]) for p in ("g", "s", "joint")]
        == [1, 1, 0],
        "meta": meta == {"phase": "s", "epoch": 0},
        "skipped": [len(sec[p]) for p in ("g", "s", "joint")] == [0, 0, 1]
        and second["start_epochs"] == {"g": 10**9, "s": 1, "joint": 0},
        "restored_bit_equal": restored.keys() == saved.keys() and all(bit_equal.values()),
        "adam_moments_saved": bool(saved["netS"]["optimizer"]["state"]),
        "resumed_joint_graphed": seen["step.graph_replays"] > 0,
        "launches": launches == want, "conv3x3_all_wgmma": all_wgmma(launches, variants)}
    sizes = {name: os.path.getsize(os.path.join(ckdir, f"{name}.pt")) for name in saved}
    shutil.rmtree(ckdir)
    phase("resume", {"saves": save_s, "file_bytes": sizes, "bit_equal": bit_equal,
                     "resumed_epoch_seconds": sec, "launches": launches,
                     "derived_launches": want, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"resume checks failed: {checks}")
    return launches


def profile_phase(torch, tdir, work):
    """demos.demo_usss under --profile-dir on the train phase's scene, one G
    pretrain and one joint epoch (8 steps) and the fused inference: the
    torch.profiler trace written into the directory holds a CUDA kernel
    event of each hand-written kernel the run launched, by its symbol
    (channel_sums and channel_sums_pair share channel_sums_kernel), and the
    launches equal the derived counts."""
    from fcdgan_tpu_torch.demos import demo_usss

    prof = os.path.join(work, "profile")
    counters = kernel_counters()
    reset_launches(counters)
    t0 = time.perf_counter()
    with step_calls() as seen:
        out = demo_usss.main(train_args(tdir, "_prof", (1, 0, 1), "--profile-dir", prof,
                                        "--save-checkpoints", "false"))
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    want, _ = derived_launches(torch, out["tiles"], (1, 0, 1), seen=seen)
    on_device, _ = derived_launches(torch, out["tiles"], (1, 0, 1))
    on_device["channel_sums"] += on_device.pop("channel_sums_pair")
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    events = collections.Counter()
    if traces:
        with open(os.path.join(prof, traces[0])) as f:
            for e in json.load(f).get("traceEvents", []):
                if e.get("cat") == "kernel":
                    name = str(e.get("name", "")).lower()
                    for kname, sym in KERNEL_SYMBOLS.items():
                        events[kname] += sym in name
    launched = {kname for kname, n in launches.items() if n}
    checks = {
        "one_trace": len(traces) == 1,
        "kernel_events": all(events["channel_sums" if kname == "channel_sums_pair" else kname]
                             for kname in launched),
        "kernel_events_derived": all(events[k] == n for k, n in on_device.items()),
        "launches": launches == want, "conv3x3_all_wgmma": all_wgmma(launches, variants)}
    trace_mb = sum(os.path.getsize(os.path.join(prof, f)) for f in traces) / 1e6
    shutil.rmtree(prof)
    phase("profile", {"seconds": seconds, "trace_mb": trace_mb, "kernel_events": dict(events),
                      "derived_kernel_events": on_device, "step_calls": dict(seen),
                      "launches": launches, "derived_launches": want, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"profile checks failed: {checks}")
    return launches


def wsss_split_phase(torch, root, wsss):
    """demos.demo_wsss with --siamese-stats split (S and D) on the wsss
    phase's slices, one adversarial epoch (its GModel.pkl reused, so no G
    pretrain), then the train-mode inference: the maps, finite losses, each
    kernel's launches equal to the count derived from the split models, all
    conv3x3 on wgmma; the adversarial epoch's rate beside the joint wsss
    phase's (same call)."""
    from fcdgan_tpu_torch.data.raster import read_image
    from fcdgan_tpu_torch.demos import demo_wsss

    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    t0 = time.perf_counter()
    with step_calls() as seen:
        out = demo_wsss.main(wsss_args(root, "_split", (WSSS_EPOCHS[0], 1),
                                       "--siamese-stats", "split"))
    seconds = time.perf_counter() - t0
    launches, variants = launch_counts(counters)
    want, per_step = derived_wsss_launches(torch, (0, 1), split=True, seen=seen)
    names = sorted(os.listdir(out["density_dir"]))
    losses = [v for ph in out["epoch_metrics"].values() for m in ph for v in m.values()]
    warm = wsss["epoch_seconds"]["adv"][1:]
    checks = {
        "split": out["sstate"].siamese_stats == out["dstate"].siamese_stats == "split",
        "g_reused": out["g_pretrain_epochs"] == 0,
        "adversarial_graphed": seen["step.graph_replays"] > 0
        and seen["step.eager"] == seen["step.graph_captures"] > 0,
        "maps": len(names) == WSSS_SLICES[0] and all(
            read_image(os.path.join(out["density_dir"], n)).shape == (WSSS_SIZE, WSSS_SIZE, 1)
            for n in names),
        **_driver_checks(out, launches, variants, want, losses)}
    phase("wsss_split", {
        "seconds": seconds, "adv_epoch_seconds": out["epoch_seconds"]["adv"],
        "adv_epochs_per_s": 1.0 / out["epoch_seconds"]["adv"][0],
        "joint_mode_adv_epochs_per_s_warm": len(warm) / sum(warm),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "derived_launches": want, "per_step": per_step,
        "step_calls": dict(seen), "oa": float(out["evaluator"].Pixel_Accuracy()),
        "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"wsss_split checks failed: {checks}")
    return launches, out


def wsss_eraser_run(torch, root, wsss):
    """demos.demo_wsss with --random-eraser on the wsss phase's slices, one
    adversarial epoch (GModel.pkl reused): the Python pair loader (feed
    host), launches as derived; its rate beside the resident wsss phase's."""
    from fcdgan_tpu_torch.demos import demo_wsss

    counters = kernel_counters()
    reset_launches(counters)
    with step_calls() as seen:
        out = demo_wsss.main(wsss_args(root, "_eraser", (WSSS_EPOCHS[0], 1),
                                       "--random-eraser", "true"))
    launches, variants = launch_counts(counters)
    want, _ = derived_wsss_launches(torch, (0, 1), seen=seen)
    losses = [v for ph in out["epoch_metrics"].values() for m in ph for v in m.values()]
    warm = wsss["epoch_seconds"]["adv"][1:]
    res = {"feed": out["feed"], "adv_epochs_per_s": 1.0 / out["epoch_seconds"]["adv"][0],
           "resident_adv_epochs_per_s_warm": len(warm) / sum(warm),
           "launches": launches, "derived_launches": want,
           "step_calls": dict(seen),
           "checks": {"host_feed": out["feed"] == "host",
                      "adversarial_graphed": seen["step.graph_replays"] > 0,
                      **_driver_checks(out, launches, variants, want, losses)}}
    return res


def rsss_eraser_run(torch, root, rsss):
    """demos.demo_rsss with --random-eraser on the rsss phase's scenes, one
    adversarial epoch and its test evaluation (GModel.pkl reused): the train
    list on BatchLoader (feed host), the test list on the native loader,
    launches as derived; its rate beside the resident rsss phase's."""
    from fcdgan_tpu_torch.demos import demo_rsss

    counters = kernel_counters()
    reset_launches(counters)
    out = demo_rsss.main(rsss_args(root, "_eraser", (RSSS_EPOCHS[0], 1), "--random-eraser",
                                   "true"))
    launches, variants = launch_counts(counters)
    want, _ = derived_rsss_launches(torch, out["tiles"], out["test_tiles"], (0, 1))
    losses = [v for ph in out["epoch_metrics"].values() for m in ph
              for key, v in m.items() if key != "f1"]
    warm = rsss["epoch_seconds"]["adv"][1:]
    res = {"feed": out["feed"], "test_feed": out["test_feed"],
           "adv_epochs_per_s": 1.0 / out["epoch_seconds"]["adv"][0],
           "resident_adv_epochs_per_s_warm": len(warm) / sum(warm),
           "test_eval_seconds": out["epoch_seconds"]["test"],
           "launches": launches, "derived_launches": want,
           "checks": {"host_feed": out["feed"] == "host",
                      **_driver_checks(out, launches, variants, want, losses)}}
    return res


def eraser_phase(wsss_run, rsss_run):
    """The two --random-eraser runs: each kernel's launches summed."""
    checks = {f"{mode}_{key}": ok for mode, run in (("wsss", wsss_run), ("rsss", rsss_run))
              for key, ok in run["checks"].items()}
    phase("eraser", {"wsss": wsss_run, "rsss": rsss_run, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"eraser checks failed: {checks}")
    return {name: wsss_run["launches"][name] + rsss_run["launches"][name]
            for name in wsss_run["launches"]}


def dp_world1_phase(torch, tdir):
    """demo_usss --n-devices 1 (a world of one: NCCL, the padded tail, every
    all-reduce) beside the same driver with --tail pad and no process group,
    on the train phase's scene and epochs, each twice in turns. bf16
    training on the card is not bitwise repeatable (cuDNN's and the bilinear
    upsample's backwards), so the densities and each epoch's losses of a
    world-of-one run and a no-group run must agree within the larger of
    DP_WORLD1_FLOORS and twice the gap between two runs of one kind;
    launches equal to the derived ones;
    joint epochs/s of each. Then profile_train's USSS joint step in the
    world of one and without a group: the all-reduce calls a step and their
    device ms (the world's device copies and NCCL kernels over the no-group
    step's)."""
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.demos import demo_usss
    from fcdgan_tpu_torch.parallel import mesh
    from fcdgan_tpu_torch.tools import profile_train

    counters = kernel_counters()
    runs = {}
    for tag, extra in (("world1", ("--n-devices", "1")), ("no_group", ("--tail", "pad")),
                       ("world1_b", ("--n-devices", "1")), ("no_group_b", ("--tail", "pad"))):
        reset_launches(counters)
        t0 = time.perf_counter()
        with step_calls() as seen:
            out = demo_usss.main(train_args(tdir, f"_{tag}", TRAIN_EPOCHS, *extra))
        runs[tag] = {"out": out, "seconds": time.perf_counter() - t0,
                     "launches": launch_counts(counters), "step_calls": seen,
                     "density": open_raster(out["density_path"]).read_block()[..., 0]}
    n = runs["world1"]["out"]["tiles"]
    want = {t: derived_launches(torch, n, seen=r["step_calls"])[0] for t, r in runs.items()}

    def gaps(a, b):
        ra, rb = runs[a], runs[b]
        em_a, em_b = ra["out"]["epoch_metrics"], rb["out"]["epoch_metrics"]
        return (float(np.abs(ra["density"] - rb["density"]).max()),
                max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12) for ph in em_a
                    for x, y in zip(em_a[ph], em_b[ph]) for k in x))

    cross = [gaps("world1", "no_group"), gaps("world1_b", "no_group_b")]
    spread = [gaps("world1", "world1_b"), gaps("no_group", "no_group_b")]
    tol = [max(floor, 2 * max(s[i] for s in spread))
           for i, floor in enumerate(DP_WORLD1_FLOORS)]
    prof = {n: profile_train.main(["--mode", "usss", "--steps", "3", "--top", "8",
                                   "--n-devices", str(n)]) for n in (1, 0)}

    def coll_ms(p):
        return p["nccl_kernel_ms"] + p["dtod_copy_ms"]

    k = _model_counts(torch, PATCH)
    bn_passes = 2 * (k["g_bns"] + k["s_bns"])  # forward and backward of each BN
    em = {t: r["out"]["epoch_metrics"] for t, r in runs.items()}
    checks = {
        "no_group_left": not mesh.group_active(),
        "densities_within": all(c[0] <= tol[0] for c in cross),
        "losses_within": all(c[1] <= tol[1] for c in cross),
        "epochs": all(len(em[t][ph]) == n for t in em
                      for ph, n in zip(("g", "s", "joint"), TRAIN_EPOCHS)),
        **{f"launches_{t}": r["launches"][0] == want[t] for t, r in runs.items()},
        "world1_eager": all(not r["step_calls"]["step.graph_captures"]
                            for t, r in runs.items() if t.startswith("world1")),
        **{f"conv3x3_all_wgmma_{t}": all_wgmma(*r["launches"]) for t, r in runs.items()},
        "allreduces_cover_every_bn": prof[1]["allreduce_calls"] >= bn_passes,
        "no_collective_without_group": prof[0]["allreduce_calls"] == 0,
    }
    phase("dp_world1", {
        "backend": "nccl", "tiles": runs["world1"]["out"]["tiles"],
        "density_max_abs": {"world1_vs_no_group": [c[0] for c in cross],
                            "same_kind": [s[0] for s in spread], "tol": tol[0]},
        "loss_max_rel": {"world1_vs_no_group": [c[1] for c in cross],
                         "same_kind": [s[1] for s in spread], "tol": tol[1]},
        "density_bit_equal": [c[0] == 0.0 for c in cross],
        "joint_epochs_per_s": {t: epoch_rates(r["out"]["epoch_seconds"])["joint"]
                               for t, r in runs.items()},
        "seconds": {t: r["seconds"] for t, r in runs.items()},
        "allreduce_calls_per_step": prof[1]["allreduce_calls"],
        "bn_passes_per_step": bn_passes,
        "allreduce_device_ms_per_step": coll_ms(prof[1]) - coll_ms(prof[0]),
        "collective_copies": {"world1": prof[1]["dtod_copies"],
                              "no_group": prof[0]["dtod_copies"]},
        "nccl_kernels_per_step": prof[1]["nccl_kernels"],
        "step_ms_median": {"world1": prof[1]["step_ms_unprofiled_median"],
                           "no_group": prof[0]["step_ms_unprofiled_median"]},
        "device_busy_ms": {"world1": prof[1]["device_busy_ms"],
                           "no_group": prof[0]["device_busy_ms"]},
        "launches": runs["world1"]["launches"][0], "derived_launches": want["world1"],
        "step_calls": {t: dict(r["step_calls"]) for t, r in runs.items()},
        "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dp_world1 checks failed: {checks}")
    return runs["world1"]["launches"][0]


DP_USSS_ITEMS = [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]  # 8 tiles and 2 weight-0 duplicates
DP_WSSS_PAIRS = WSSS_BATCH  # 15 pairs, wrap-padded to 16 for two ranks


def _dp_batches():
    """The padded global batches of dp_two_ranks: the USSS index batch of the
    train phase's scene and 15 seeded WHU-sized pairs padded to 16."""
    import numpy as np

    from fcdgan_tpu_torch.parallel import mesh

    rng = np.random.default_rng(3)

    def pair():
        x = rng.normal(size=(DP_WSSS_PAIRS, WSSS_SIZE, WSSS_SIZE, 3)).astype(np.float32)
        return x, (0.9 * x + 0.1 + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)

    c_x, c_y = pair()
    c_y[:, 60:140, 50:150] += 2.0
    nc_x, nc_y = pair()
    c_ref = np.zeros((DP_WSSS_PAIRS, WSSS_SIZE, WSSS_SIZE, 1), np.float32)
    c_ref[:, 60:140, 50:150] = 1.0
    wsss = mesh.pad_batch_to_multiple(
        {"c_x": c_x, "c_y": c_y, "c_ref": c_ref, "nc_x": nc_x, "nc_y": nc_y,
         "weight": np.ones(DP_WSSS_PAIRS, np.float32)}, 2)
    usss = {"item": np.asarray(DP_USSS_ITEMS, np.int64),
            "weight": np.asarray([1.0] * 8 + [0.0] * 2, np.float32)}
    return usss, wsss


def _dp_steps(torch, tdir, state, usss, wsss, seed=None):
    """One USSS joint and one WSSS adversarial step in f32 on this rank's
    slices of the padded global batches (the whole batches without a group),
    from the seeded ``state``: per step, metrics, state dicts and the summed
    gradients on the CPU, the kernels' launches and the passes of the step
    they count (a graphed step's first call: two, ``step_calls``; an eager
    step, as under a group: one). With ``seed`` each image element is
    scaled by (1 + 1e-7 N(0, 1)), about one float32 rounding (the
    witness)."""
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
    from fcdgan_tpu_torch.parallel import mesh
    from fcdgan_tpu_torch.train.optim import adam, rmsprop
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps, WSSSSteps

    scaler = Normalize(*dataset_meanstd(os.path.join(tdir, "T1_stats.txt"),
                                        os.path.join(tdir, "T2_stats.txt"), None))
    ds = ScenePairDataset(os.path.join(tdir, "T1.tif"), os.path.join(tdir, "T2.tif"),
                          ref_path=os.path.join(tdir, "ref.tif"), enhance=scaler,
                          patch_size=(PATCH, PATCH), overlap_padding=(PAD, PAD))
    vgg = VGG16Weights(vgg16_random_params(0), "cuda")
    counters = kernel_counters()

    def nets(*names):
        made = {"g": Generator(3), "s": Segmentor(3), "d": Discriminator(3)}
        for n in names:
            made[n].load_state_dict(state[n])
            made[n].cuda()
        return [made[n] for n in names]

    def result(m, passes=1, **named):
        torch.cuda.synchronize()
        return {"metrics": {k: v.detach().cpu() for k, v in m.items()}, "passes": passes,
                "state": {n: {k: v.detach().cpu() for k, v in net.state_dict().items()}
                          for n, net in named.items()},
                "grads": {n: {k: p.grad.detach().cpu() for k, p in net.named_parameters()
                              if p.grad is not None} for n, net in named.items()},
                "launches": launch_counts(counters)[0]}

    gen = torch.Generator("cuda")

    def scaled(t):
        if seed is None:
            return t
        gen.manual_seed(seed)
        return t * (1 + 1e-7 * torch.randn(t.shape, device=t.device, generator=gen))

    out = {}
    g, s = nets("g", "s")
    steps = USSSSteps(g, s, adam(g.parameters()), adam(s.parameters()), vgg,
                      PerceptionConfig((29,), True), 0.4, 0.65, 0.0, ds.grid.interior_sizes(),
                      (PAD, PAD))
    db = DeviceSceneCache(ds, scaler, "cuda").complete(mesh.shard_batch(usss))
    db["x"], db["y"] = scaled(db["x"]), scaled(db["y"])
    reset_launches(counters)
    with step_calls() as seen:
        m = steps.joint(db["x"], db["y"], db["ref"], db["item"], db["weight"], 1e-4, 1e-4)
    out["usss_joint"] = result(m, host_steps(1, seen), g=g, s=s)
    del steps, db
    g, s, d = nets("g", "s", "d")
    steps = WSSSSteps(g, s, d, adam(g.parameters()), rmsprop(s.parameters()),
                      rmsprop(d.parameters()), vgg, PerceptionConfig((3,), False), 0.5, 0.0,
                      0.2, 1.6, 1.0, 1.5, prob_thresh=0.6)
    t = {k: scaled(torch.from_numpy(v).cuda()) if k.endswith(("_x", "_y"))
         else torch.from_numpy(v).cuda() for k, v in mesh.shard_batch(wsss).items()}
    reset_launches(counters)
    with step_calls() as seen:
        m = steps.adversarial(t["c_x"], t["c_y"], t["c_ref"], t["nc_x"], t["nc_y"],
                              t["weight"], 1e-4, 5e-5)
    out["wsss_adversarial"] = result(m, host_steps(1, seen), g=g, s=s, d=d)
    del steps
    gc.collect()
    return out


def dp_rank(index, tdir, store, state, usss, wsss, out_dir):
    """One of dp_two_ranks' ranks: gloo on cuda:0, shared with the other."""
    import torch

    from fcdgan_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with mesh.world_group(index, 2, "file://" + store, torch.device("cuda", 0),
                          backend="gloo"):
        out = _dp_steps(torch, tdir, state, usss, wsss)
    torch.save(out, os.path.join(out_dir, f"rank{index}.pt"))


def _dp_compare(torch, got, want, witness, state):
    """Rank 0's step against the one-process step on the same padded batch.
    The gates are the card-vs-CPU parity bounds of train_parity (losses
    rtol 1e-4, each net's gradient norm rtol 1e-3, BN running stats atol
    1e-4), the confusion equal, and the CPU tests' parameter bound (within
    1e-5 of the largest plus 1e-3 of the update wherever the gradients agree
    within 1e-3). Reported beside them: the CPU tests' own measures (largest
    relative metric and BN gaps, gradient gaps over the witness's, the same
    step on the batch scaled by one float32 rounding), which the card's
    half-batch convolutions, other cuDNN algorithms than the whole batch's,
    exceed."""
    m = {"metric_rel": 0.0, "bn_stats_max_abs": 0.0, "bn_stats_rel": 0.0, "grad_norm_rel": 0.0,
         "grad_gap_over_witness": 0.0, "param_excess": 0.0, "worst_bn": None}
    confusion_equal = torch.equal(got["metrics"]["confusion"], want["metrics"]["confusion"])
    for k, v in want["metrics"].items():
        if k != "confusion":
            rel = abs(float(got["metrics"][k]) - float(v)) / max(abs(float(v)), 1e-12)
            m["metric_rel"] = max(m["metric_rel"], rel)
    same_keys = True
    for net, grads in want["grads"].items():
        same_keys &= sorted(got["grads"][net]) == sorted(grads)
        if grads:
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
            got_norm = torch.sqrt(sum(got["grads"][net][k].double().square().sum()
                                      for k in grads))
            m["grad_norm_rel"] = max(m["grad_norm_rel"], float(abs(got_norm - norm) / norm))
        for k, v in grads.items():
            gap = float((got["grads"][net][k] - v).norm())
            own = max(float((witness[net][k] - v).norm()), 1e-30)
            m["grad_gap_over_witness"] = max(m["grad_gap_over_witness"], gap / own)
        for k, v in want["state"][net].items():
            p = got["state"][net][k]
            if not v.is_floating_point():
                same_keys &= torch.equal(p, v)
                continue
            if k.endswith(("running_mean", "running_var")):
                gap = float((p - v).abs().max())
                if gap > m["bn_stats_max_abs"]:
                    m["bn_stats_max_abs"], m["worst_bn"] = gap, f"{net}.{k}"
                m["bn_stats_rel"] = max(m["bn_stats_rel"],
                                        gap / max(float(v.abs().max()), 1e-30))
                continue
            tol = 1e-5 * float(v.abs().max()) + 1e-3 * (v - state[net][k]).abs()
            same = torch.ones_like(v, dtype=torch.bool)
            if k in grads:
                same = (got["grads"][net][k] - grads[k]).abs() <= 1e-3 * grads[k].abs()
            excess = ((p - v).abs() - tol)[same]
            if excess.numel():
                m["param_excess"] = max(m["param_excess"], float(excess.max()))
    m["confusion_equal"] = bool(confusion_equal)
    ok = (confusion_equal and same_keys and m["metric_rel"] <= 1e-4
          and m["bn_stats_max_abs"] <= 1e-4 and m["grad_norm_rel"] <= 1e-3
          and m["param_excess"] <= 0)
    return bool(ok), m


def dp_two_ranks_phase(torch, tdir, work):
    """Two ranks share the card over gloo (NCCL takes one rank per device):
    one USSS joint step on the train phase's scene (8 tiles and 2 weight-0
    duplicates) and one WSSS adversarial step on 15 seeded 200² pairs
    wrap-padded to 16, f32 at full width, each rank on its half, against the
    single-process step on the same padded batch (``_dp_compare``); both
    ranks' states bit-equal; each rank's launches a pass of the step as the
    one process's."""
    import torch.multiprocessing as mp

    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor

    phase("dp_two_ranks_backend", {"backend": "gloo", "ranks": 2, "device": "cuda:0",
                                   "why": "NCCL takes one rank per device; both ranks "
                                          "share the one card"})
    torch.manual_seed(0)
    state = {n: {k: v.clone() for k, v in net.state_dict().items()}
             for n, net in (("g", Generator(3)), ("s", Segmentor(3)), ("d", Discriminator(3)))}
    usss, wsss = _dp_batches()
    out_dir = os.path.join(work, "dp_two_ranks")
    os.makedirs(out_dir)
    gc.collect()
    torch.cuda.empty_cache()  # the cached blocks of earlier phases, for the ranks
    t0 = time.perf_counter()
    mp.start_processes(dp_rank, args=(tdir, os.path.join(out_dir, "rdv"), state, usss, wsss,
                                      out_dir),
                       nprocs=2, join=True, start_method="spawn")
    rank_seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{i}.pt"), weights_only=False)
             for i in (0, 1)]
    want = _dp_steps(torch, tdir, state, usss, wsss)
    witness = _dp_steps(torch, tdir, state, usss, wsss, seed=1)
    results, checks = {}, {}
    for step in ("usss_joint", "wsss_adversarial"):
        ok, worst = _dp_compare(torch, ranks[0][step], want[step], witness[step]["grads"],
                                state)
        equal = all(torch.equal(ranks[1][step]["state"][n][k], v)
                    for n, sd in ranks[0][step]["state"].items() for k, v in sd.items())
        checks[f"{step}_within_bounds"] = ok
        checks[f"{step}_ranks_bit_equal"] = equal
        results[step] = {"worst": worst, "ranks_bit_equal": equal,
                         "launches_rank0": ranks[0][step]["launches"],
                         "launches_one_process": want[step]["launches"],
                         "passes_rank0_one_process": [ranks[0][step]["passes"],
                                                      want[step]["passes"]]}
        r, w = ranks[0][step], want[step]  # launches a pass of the step, on each side
        checks[f"{step}_launches_as_one_process"] = (
            {k: n * w["passes"] for k, n in r["launches"].items()}
            == {k: n * r["passes"] for k, n in w["launches"].items()})
    phase("dp_two_ranks", {"backend": "gloo", "ranks_seconds": rank_seconds,
                           "usss_tiles": len(usss["item"]), "wsss_pairs": len(wsss["weight"]),
                           **results, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"dp_two_ranks checks failed: {checks}")
    shutil.rmtree(out_dir)
    return {name: sum(r[step]["launches"][name] for r in ranks for step in r)
            for name in ranks[0]["usss_joint"]["launches"]}


def serve_dp_phase(torch, work, smodel, fused):
    """tools.infer --n-devices 1 on the 2048² scene: the streaming path in a
    world of one (NCCL; each batch split over the ranks and gathered),
    within the parity bound (1e-3) of the fused batch-exact density
    ``fused``; 3 conv3x3 and 4 phase_pool launches a batch; px_per_s."""
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.parallel import mesh
    from fcdgan_tpu_torch.tools import infer

    counters = kernel_counters()
    batches = math.ceil(math.ceil(SCENE / (PATCH - 2 * PAD)) ** 2 / BATCH)
    want = derived_serve_launches(counters, _model_counts(torch, PATCH), batches)
    reset_launches(counters)
    out = infer.run(infer.InferConfig(dir=work, smodel=smodel, ref_name="ref.tif",
                                      batch_size=BATCH, n_devices=1, ext="_dp",
                                      progress=False))
    launches, variants = launch_counts(counters)
    diff = float(np.abs(open_raster(out["density_path"]).read_block()[..., 0] - fused).max())
    checks = {"within_parity": diff <= 1e-3, "streamed": not out["fused"],
              "no_group_left": not mesh.group_active(),
              "metrics_finite": all(math.isfinite(out[k]) for k in ("oa", "f1")),
              "launches": launches == want, "conv3x3_all_wgmma": all_wgmma(launches, variants)}
    phase("serve_dp", {"backend": "nccl", "pixels": out["pixels"], "px_per_s": out["px_per_s"],
                       "seconds": out["seconds"], "feed": out["feed"], "batches": batches,
                       "max_abs_diff_to_fused": diff, "tol": 1e-3, "launches": launches,
                       "derived_launches": want, "conv3x3_variants": variants,
                       "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve_dp checks failed: {checks}")
    return launches


BENCH_TILES = 36  # tiles of the 1024² USSS scene at patch 220, padding 10 (PERF.md §4)


def _bench_line(line, metric, unit, in_run_ab=False):
    """A bench line's metric, unit, positive finite value and vs_baseline
    (-1.0, or a positive in-run A/B)."""
    return bool(line["metric"] == metric and line["unit"] == unit
                and math.isfinite(line["value"]) and line["value"] > 0
                and (line["vs_baseline"] > 0 if in_run_ab else line["vs_baseline"] == -1.0))


def bench_phase(torch):
    """Every mode of ``fcdgan_tpu_torch.tools.bench`` once at the JAX bench's
    defaults, in this process (the bench prints its JSON lines): each line's
    metric, unit and value; the 36 tiles of the USSS scene; each kernel's
    launches in the default mode and the three driver modes equal to the
    count derived for the steps they ran (one warm epoch, the timed ones, and
    the step-only window of the adversarial modes), every bf16 conv3x3 on
    wgmma; the six kernels launched in every training mode, conv3x3 and
    phase_pool alone in --inference; --scaling at n = 1 on the card (64
    collective calls a step) and the JAX error row past it."""
    from fcdgan_tpu_torch.tools import bench

    counters = kernel_counters()
    dev = torch.device("cuda", 0)
    _, usss = derived_launches(torch, BENCH_TILES)
    _, wsss = derived_wsss_launches(torch)
    _, rsss = derived_rsss_launches(torch, 2 * BENCH_TILES, 0)
    runs, checks, launches, calls = {}, {}, {}, {}

    def run(name, fn, *args, **kw):
        reset_launches(counters)
        t0 = time.perf_counter()
        with step_calls() as calls[name]:
            runs[name] = fn(*args, **kw)
        launches[name] = launch_counts(counters)
        runs[name + "_seconds"] = time.perf_counter() - t0
        return runs[name]

    def derived(name, per_step, kind, n_steps):
        got, variants = launches[name]
        passes = host_steps(n_steps, calls[name])  # RSSS counts no step: n_steps
        want = {k: per_step[k].get(kind, 0) * passes for k in counters}
        checks[name + "_launches"] = got == want and all_wgmma(got, variants)
        return {"launches": got, "derived": want, "steps": n_steps,
                "step_calls": dict(calls[name])}

    torch.cuda.empty_cache()
    out = {}
    line = run("default", bench.main_default, dev)
    checks["default"] = (_bench_line(line, "usss_driver_joint_epochs_per_s", "epochs/s")
                         and line["step_mpx_per_s"] > 0
                         and line["tiles_per_epoch"] == BENCH_TILES)
    # 3 warm + 20 timed steps, then the driver: one warm epoch and 3 timed
    out["default"] = derived("default", usss, "joint", 23 + 4 * line["batches_per_epoch"])
    line = run("driver", bench.bench_driver, dev)
    checks["driver"] = (_bench_line(line, "usss_driver_joint_epochs_per_s", "epochs/s")
                        and line["tiles_per_epoch"] == BENCH_TILES
                        and line["batches_per_epoch"] == 4 and line["feed"] == "scene_cache")
    out["driver"] = derived("driver", usss, "joint", 4 * line["batches_per_epoch"])
    for dd in ("float32", "uint8"):
        line = run(f"inference_{dd}", bench.bench_inference, dev, dd)
        got, variants = launches[f"inference_{dd}"]
        checks[f"inference_{dd}"] = (
            _bench_line(line, f"usss_infer_throughput_{dd}", "Mpx/s", in_run_ab=True)
            and got["conv3x3"] > 0 and got["phase_pool"] > 0 and all_wgmma(got, variants)
            and not any(got[k] for k in ("pool_bwd", "fused_ssim", "channel_sums",
                                         "channel_sums_pair")))
    line = run("pretrain", bench.bench_pretrain, dev)
    checks["pretrain"] = _bench_line(line, "usss_pretrain_throughput", "Mpx/s", True)
    for mode, fn in (("wsss", bench.bench_wsss), ("rsss", bench.bench_rsss)):
        checks[mode] = _bench_line(run(mode, fn, dev), f"{mode}_adversarial_throughput",
                                   "Mpx/s")
    line = run("wsss_driver", bench.bench_wsss_driver, dev)
    checks["wsss_driver"] = (_bench_line(line, "wsss_driver_adversarial_epochs_per_s",
                                         "epochs/s")
                             and line["pairs_per_epoch"] == WSSS_SLICES[0]
                             and line["feed"] == "slice_cache")
    out["wsss_driver"] = derived("wsss_driver", wsss, "adversarial",
                                 4 * line["batches_per_epoch"] + 21)
    line = run("rsss_driver", bench.bench_rsss_driver, dev)
    checks["rsss_driver"] = (_bench_line(line, "rsss_driver_adversarial_epochs_per_s",
                                         "epochs/s")
                             and line["tiles_per_epoch"] == 2 * BENCH_TILES
                             and line["feed"] == "tile_cache")
    out["rsss_driver"] = derived("rsss_driver", rsss, "adversarial",
                                 4 * line["batches_per_epoch"] + 21)
    rows = run("batch_sweep", bench.bench_batch_sweep, dev)
    by_bs = collections.defaultdict(list)
    for r in rows:
        by_bs[int(r["metric"].split("_bs")[1].split("_")[0])].append(r)
    checks["batch_sweep"] = sorted(by_bs) == [10, 20, 40, 80] and all(
        any(r["value"] > 0 for r in rs) and all(r["value"] > 0 or "error" in r for r in rs)
        for rs in by_bs.values())
    gc.collect()
    held = {"allocated_gb": torch.cuda.memory_allocated(dev) / 1e9,
            "reserved_gb": torch.cuda.memory_reserved(dev) / 1e9}
    rows = run("scaling", bench.bench_scaling, dev, timeout=600)
    have = torch.cuda.device_count()
    checks["scaling"] = [r["metric"] for r in rows] == [
        f"usss_dp_scaling_n{n}" for n in (1, 2, 4, 8)] and all(
        (_bench_line(r, r["metric"], "ms/step") and r["all_reduce_ops"] == 64
         and r["global_batch"] == 2 * n) if n <= have
        else (r["value"] == -1.0 and r["error"] == f"need {n} devices, have {have}")
        for n, r in zip((1, 2, 4, 8), rows))
    for name in ("default", "pretrain", "wsss", "rsss", "batch_sweep"):
        got, variants = launches[name]
        checks[name + "_all_six"] = all(got.values()) and all_wgmma(got, variants)
    phase("bench", {"seconds": {k: v for k, v in runs.items() if k.endswith("_seconds")},
                    "driver_launches": out, "held_before_scaling": held,
                    "scaling_rows": rows, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"bench checks failed: {checks}")
    return {f"bench_{name}": o["launches"] for name, o in out.items()}


def opt_layouts_phase(torch):
    """The flat and grouped optimizer layouts (``FCDGAN_OPT``) on the card:
    one USSS joint step (batch 10 at 220 px) and one WSSS adversarial step
    (15 pairs of 200 px) of the bench's bf16 setups in each layout, with
    finite metrics and every stepped net moved; and each layout's update
    from the leaf step's own gradients and initial parameters, held against
    the leaf step's parameters within the CPU tests' bound (rtol 1e-6, atol
    1e-7): bf16 steps do not repeat bitwise on the card, so the layouts are
    compared on the same gradients."""
    from fcdgan_tpu_torch.tools import bench
    from fcdgan_tpu_torch.train import optim

    dev = torch.device("cuda", 0)
    kinds = {  # setup, one step, the (optimizer, net, rate) of each stepped net
        "usss_joint": (lambda: bench.usss_setup(dev),
                       lambda st, d: bench._joint(st, bench._on(dev, d)),
                       lambda st: ((st.opt_g, st.G, 1e-4), (st.opt_s, st.S, 1e-4))),
        "wsss_adversarial": (lambda: bench.wsss_setup(dev),
                             lambda st, args: st.adversarial(*args),
                             lambda st: ((st.opt_d, st.D, 1e-5), (st.opt_s, st.S, 1e-3)))}
    report, checks = {}, {}
    for kind, (setup, step, stepped) in kinds.items():
        with environ(FCDGAN_OPT="leaf"):
            st, data = setup()
        before = [[p.detach().clone() for p in net.parameters()] for _, net, _ in stepped(st)]
        step(st, data)
        after = [[p.detach().clone() for p in net.parameters()] for _, net, _ in stepped(st)]
        grads = [[None if p.grad is None else p.grad.detach().clone()
                  for p in net.parameters()] for _, net, _ in stepped(st)]
        algorithms = ["adam" if isinstance(opt, torch.optim.Adam) else "rmsprop"
                      for opt, _, _ in stepped(st)]
        for layout in ("flat", "grouped"):
            worst, ok = 0.0, True
            for (_, _, lr), algorithm, p0, p1, g in zip(stepped(st), algorithms, before,
                                                        after, grads):
                ps = [torch.nn.Parameter(t.clone()) for t in p0]
                for p, gi in zip(ps, g):
                    p.grad = None if gi is None else gi.clone()
                opt = optim.build(ps, algorithm, layout)
                optim.set_lr(opt, lr)
                opt.step()
                for p, want in zip(ps, p1):
                    gap = (p.detach() - want).abs()
                    ok &= bool((gap <= 1e-7 + 1e-6 * want.abs()).all())
                    worst = max(worst, float(gap.max()))
            with environ(FCDGAN_OPT=layout):
                st2, data2 = setup()
            start = [[p.detach().clone() for p in net.parameters()]
                     for _, net, _ in stepped(st2)]
            m = step(st2, data2)
            finite = all(math.isfinite(float(v)) for k, v in m.items() if k != "confusion")
            moved = all(any(not torch.equal(p.detach(), q) for p, q in zip(net.parameters(), p0))
                        for (_, net, _), p0 in zip(stepped(st2), start))
            is_layout = all(isinstance(opt, optim.LayoutOptimizer) for opt, _, _ in stepped(st2))
            report[f"{kind}_{layout}"] = {"replay_within_bound": ok, "max_abs_gap": worst,
                                          "step_finite": finite, "moved": moved}
            checks[f"{kind}_{layout}"] = ok and finite and moved and is_layout
            del st2, data2, m
        del st, data, before, after, grads
        torch.cuda.empty_cache()
    phase("opt_layouts", {**report, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"opt_layouts checks failed: {checks}")


def record(name, source, replaces, rows, launches, step="usss_joint"):
    """One kernel's line of the JSON summary: the sums over its rows of the
    main path's working type in ``step``, each row times its count per step
    (one serving chunk for conv3x3, comparable with its earlier slices; one
    USSS joint step for the others, so the Discriminator's channel-sum rows
    of a WSSS step stay in the per-shape detail)."""
    dt = "bfloat16" if any(r["dtype"] == "bfloat16" for r in rows) else "float32"
    rows = [r for r in rows if r["dtype"] == dt and r.get("step", "usss_joint") == step]
    by = {}
    for r in rows:
        k = r.get("per_step", 1)
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + k * r["bound_ms"]
    lib = [r["library_ms"] for r in rows]

    def total(key):
        return sum(r.get("per_step", 1) * r[key] for r in rows)

    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(by, key=by.get),
            "library_ms": None if None in lib else total("library_ms")}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from fcdgan_tpu_torch.data.synthetic import make_usss_scene

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    rows = {"conv3x3": conv_rows(torch, F), "pool_bwd": pool_rows(torch, F),
            "fused_ssim": ssim_rows(torch)}
    bn_shapes, pool_shapes = step_shapes(torch)
    bn = bn_rows(torch, bn_shapes)
    rows["channel_sums"] = [r for r in bn if r["name"] == "channel_sums"]
    rows["channel_sums_pair"] = [r for r in bn if r["name"] == "channel_sums_pair"]
    rows["phase_pool"] = phase_pool_rows(torch, F, pool_shapes)

    work = os.path.join(ROOT, "chiprun_out", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:  # the scenes and rasters (tens of MB) go whatever happens
        scene = make_usss_scene(work, SCENE, SCENE, 3, seed=0, dtype="uint16",
                                rects=((300, 400, 250, 180), (1200, 900, 300, 420),
                                       (1700, 1600, 200, 260)))
        smodel, ds, gpu_cache = make_model(torch, work, scene)
        serve_launches = serve_phase(torch, work, smodel)
        fused = serve_bs_phase(torch, work, smodel)
        serve_stream_phase(torch, work, smodel, fused)
        more = {"serve_dp": serve_dp_phase(torch, work, smodel, fused)}
        parity_phase(torch, smodel, ds, gpu_cache)
        del gpu_cache, fused
        torch.cuda.empty_cache()
        more.update(serve_window=serve_window_phase(torch, work, scene, smodel),
                    usss_window=usss_window_phase(torch, work, scene),
                    usss_host=usss_host_phase(torch, work, scene))
        torch.cuda.empty_cache()
        launches, tdir, train = train_phase(torch, work)
        train_parity_phase(torch, tdir)
        replay_phase(torch, tdir)
        more["usss_split"] = usss_split_phase(torch, tdir, train)
        train_parity_phase(torch, tdir, "split")
        more["remat"] = remat_phase(torch, tdir)
        more["resume"] = resume_phase(torch, tdir)
        more["profile"] = profile_phase(torch, tdir, work)
        more["dp_world1"] = dp_world1_phase(torch, tdir)
        more["dp_two_ranks"] = dp_two_ranks_phase(torch, tdir, work)
        shutil.rmtree(tdir)
        wsss_launches, wdir, wsss = wsss_phase(torch, work)
        wsss_parity_phase(torch, wdir)
        serve_whu_launches = serve_whu_phase(torch, wdir, wsss)
        more["wsss_host"] = wsss_host_phase(torch, wdir, wsss)
        more["wsss_split"], wsss_split = wsss_split_phase(torch, wdir, wsss)
        wsss_parity_phase(torch, wdir, "split")
        more["serve_whu_split"] = serve_whu_phase(torch, wdir, wsss_split, "split", ("train",))
        wsss_eraser = wsss_eraser_run(torch, wdir, wsss)
        shutil.rmtree(wdir)
        rsss_launches, rdir, rsss = rsss_phase(torch, work)
        rsss_parity_phase(torch, rdir)
        serve_oscd_launches, oscd_px_per_s = serve_oscd_phase(torch, rdir, rsss)
        more["serve_oscd_stream"] = serve_oscd_stream_phase(torch, rdir, rsss, oscd_px_per_s)
        more["rsss_host"] = rsss_host_phase(torch, rdir, rsss)
        more["eraser"] = eraser_phase(wsss_eraser, rsss_eraser_run(torch, rdir, rsss))
        shutil.rmtree(rdir)
        torch.cuda.empty_cache()
        more.update(bench_phase(torch))
        opt_layouts_phase(torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sites = {"conv3x3": ("conv3x3.cu", "conv3x3.py:103"),
             "pool_bwd": ("pool_bwd.cu", "pool_bwd.py:120"),
             "fused_ssim": ("fused_ssim.cu", "fused_ssim.py:113"),
             "channel_sums": ("channel_sums.cu", "channel_sums.py:106"),
             "channel_sums_pair": ("channel_sums.cu", "channel_sums.py:133"),
             "phase_pool": ("phase_pool.cu", "phase_pool.py:121")}
    records = []
    for name, (src, site) in sites.items():
        r = record(name, f"fcdgan_tpu_torch/csrc/{src}", f"fcdgan_tpu/ops/pallas/{site}",
                   rows[name], launches[name],
                   "serve_chunk" if name == "conv3x3" else "usss_joint")
        r["wsss_launches"] = wsss_launches[name]
        r["rsss_launches"] = rsss_launches[name]
        r["serve_launches"] = serve_launches[name]
        r["serve_oscd_launches"] = serve_oscd_launches[name]
        r["serve_whu_launches"] = serve_whu_launches[name]
        for phase_name, counts in more.items():
            r[f"{phase_name}_launches"] = counts[name]
        records.append(r)
    summary = {"kernels": records, "card": smi,
               "conv3x3_per_step": conv_per_step(rows["conv3x3"]),
               "per_shape": [r for v in rows.values() for r in v],
               "seconds": time.perf_counter() - t_start}
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
