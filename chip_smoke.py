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
             conv3x3    the three gated convs of one serving chunk (patch
                        220, batch 10 stacked to 20), bf16 and f32; library
                        F.conv2d
             pool_bwd   the 8 max-pool backwards of one training step (the
                        Segmentor's 4 at N=20, the per-band VGG's 4 at
                        N=60), bf16 and f32, bit-equal; library
                        aten.max_pool2d_with_indices_backward
             fused_ssim the 5 MS-SSIM levels of one step (N=10, 3 bands),
                        f32, atol 2e-5
  serve    tools.infer.main on a 2048x2048 3-band uint16 scene with a seeded
           full-width Segmentor (bf16): output rasters, density in [0, 1],
           finite oa/f1, conv3x3 launched 3 times per chunk; px_per_s
  parity   one chunk of 2 tiles through the port in f32 on the card and on
           the CPU (plain versions): max abs density difference <= 1e-3
  train    demos.demo_usss.main on a 1024x1024 3-band uint16 scene (patch
           220, padding 10, batch 10: 36 tiles, 4 steps per epoch), bf16,
           1 G-pretrain + 1 S-init + 3 joint epochs (20 steps), then the
           fused stitched inference: every artifact, finite losses and
           metrics, density in [0, 1], SModel loading strictly, and each
           kernel's launches equal to the count derived from the models;
           seconds per phase, joint epochs/s over the warm epochs 2-3, tile
           Mpx/s, peak device memory
  train_parity  one joint step on 2 tiles in f32 from the same seeded
           weights on the card and on the CPU: losses (rtol 1e-4), each
           net's global gradient norm (rtol 1e-3), BN running stats (atol
           1e-4), and the step's own 5 MS-SSIM levels before the relu: the
           kernel against the plain version on the card's level inputs (atol
           2e-5), the card's (ssim, cs) tables against the CPU's (atol 1e-4)

Then one JSON line of kernel records, and as the last line
{"ok": true, "device": {...}}. f32 comparisons run with TF32 off (cuDNN and
cuBLAS), set once for the whole script. The scratch files go to
chiprun_out/chip_smoke/ inside the checkout and are removed at the end.
"""

import contextlib
import functools
import json
import math
import os
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
# (pool, N, H, W, C) of one S-init or joint step: the Segmentor's Down pools
# on the stacked pair (2 x batch 10), then the per-band VGG's on the stacked
# [target; generated] planes (2 x 3 bands x batch 10)
POOL_SHAPES = [(f"{net}.pool{i + 1}", n, hw, hw, c)
               for net, n in (("S", 20), ("VGG", 60))
               for i, (hw, c) in enumerate(((220, 64), (110, 128), (55, 256), (27, 512)))]
SSIM_SHAPES = [(10, hw, hw, 3) for hw in (220, 110, 55, 28, 14)]  # MS-SSIM levels
SCENE = 2048
TRAIN_SCENE = 1024
BATCH = 10
PATCH = 220
PAD = 10
TRAIN_EPOCHS = (1, 1, 3)  # G pretrain, S init, joint


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


def device_phase():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", {"nvidia_smi": smi})
    return smi


def build_phase():
    from fcdgan_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build(["conv3x3", "pool_bwd", "fused_ssim"])
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    phase("build", {"seconds": time.perf_counter() - t0, "ptxas": ptxas})


def roofline(nbytes, flops, dtype_name):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def conv_rows(torch, F):
    from fcdgan_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for layer, n, h, w, ci, co in SERVE_SHAPES:
            x = torch.randn((n, h, w, ci), generator=gen, device="cuda").to(dt)
            bound = 1.0 / math.sqrt(9 * ci)  # torch's default conv init range
            k = ((torch.rand((3, 3, ci, co), generator=gen, device="cuda") * 2 - 1)
                 * bound).to(dt)
            got = conv3x3(x, k)
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
            row = {
                "name": "conv3x3", "layer": layer, "dtype": dtype_name,
                "shape": [n, h, w, ci, co], "max_abs_err": err, "tol": tol,
                "library_max_abs_err": lib_err,
                "ms": cuda_ms(torch, lambda: conv3x3(x, k)),
                "call_ms": call_ms(torch, lambda: conv3x3(x, k)),
                "plain_ms": cuda_ms(torch, lambda: conv3x3_plain(x, k), reps=5),
                "library_ms": cuda_ms(torch, lambda: F.conv2d(x_nchw, k_oihw, padding=1)),
                "bytes": nbytes, "flops": flops,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            phase("kernels", row)
            if not err <= tol:
                raise AssertionError(f"conv3x3 {layer} {dtype_name}: max abs err "
                                     f"{err} > tol {tol}")
            rows.append(row)
            del x, k, got, want, lib
    torch.cuda.empty_cache()
    return rows


def pool_rows(torch, F):
    """pool_bwd at the 8 pools of a step, bf16 and f32: bit-equal to its
    plain version and to torch's own max-pool backward."""
    from fcdgan_tpu_torch.ops.pool_bwd import pool_bwd, pool_bwd_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for layer, n, h, w, c in POOL_SHAPES:
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
            row = {"name": "pool_bwd", "layer": layer, "dtype": dtype_name,
                   "shape": [n, h, w, c], "max_abs_err": err, "tol": 0.0,
                   "bit_equal_plain_and_library": ok,
                   "ms": cuda_ms(torch, lambda: pool_bwd(x, dy)),
                   "call_ms": call_ms(torch, lambda: pool_bwd(x, dy)),
                   "plain_ms": cuda_ms(torch, lambda: pool_bwd_plain(x, dy), reps=5),
                   "library_ms": cuda_ms(torch, library),
                   "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}
            phase("kernels", row)
            if not (ok and err == 0):
                raise AssertionError(f"pool_bwd {layer} {dtype_name}: not bit-equal "
                                     f"(max abs err {err})")
            rows.append(row)
            del x, dy, got, want, lib, idx
    torch.cuda.empty_cache()
    return rows


def ssim_rows(torch):
    """fused_ssim at the 5 MS-SSIM levels of a step, f32, atol 2e-5."""
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level, ssim_level_plain

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    k = 11
    for n, h, w, c in SSIM_SHAPES:
        x = torch.rand((n, h, w, c), generator=gen, device="cuda")
        y = (x + 0.08 * torch.randn((n, h, w, c), generator=gen, device="cuda")).clamp(0, 1)
        got = ssim_level(x, y, 1.0)
        want = ssim_level_plain(x, y, 1.0)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        vh, vw = h - k + 1, w - k + 1
        # x and y read once, two (N, C) tables written; operations: the three
        # products per pixel, 5 maps x K taps of multiply-add along H over
        # VH x W and along W over VH x VW, and about 20 for the two maps
        nbytes = 2 * x.numel() * 4 + 2 * n * c * 4
        flops = n * c * (3 * h * w + 10 * k * vh * w + (10 * k + 20) * vh * vw)
        bound_ms, bound_by = roofline(nbytes, flops, "float32")
        row = {"name": "fused_ssim", "layer": f"level {h}x{w}", "dtype": "float32",
               "shape": [n, h, w, c], "max_abs_err": err, "tol": 2e-5,
               "ms": cuda_ms(torch, lambda: ssim_level(x, y, 1.0)),
               "call_ms": call_ms(torch, lambda: ssim_level(x, y, 1.0)),
               "plain_ms": cuda_ms(torch, lambda: ssim_level_plain(x, y, 1.0), reps=5),
               "library_ms": None, "bytes": nbytes, "flops": flops,
               "bound_ms": bound_ms, "bound_by": bound_by}
        phase("kernels", row)
        if not err <= 2e-5:
            raise AssertionError(f"fused_ssim {h}x{w}: max abs err {err} > 2e-5")
        rows.append(row)
    return rows


def derived_launches(torch, n_tiles):
    """Each kernel's launches in the train phase, from the models' structure:
    the gated 3x3 convs of G and S (at the resolution each runs at), the
    Segmentor's Down pools, the VGG pools before the deepest tap, the
    MS-SSIM levels as large as the window, and the steps per epoch."""
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import _CFG, select_feature_layers
    from fcdgan_tpu_torch.ops.conv3x3 import gate

    def gated(module, hw):
        return sum(1 for m in module.modules()
                   if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3)
                   and gate(hw, hw, m.in_channels, m.out_channels))

    net_g, net_s = Generator(3), Segmentor(3)
    g_convs = gated(net_g, PATCH)
    blocks = [(net_s.inc, 0), (net_s.down1, 1), (net_s.down2, 2), (net_s.down3, 3),
              (net_s.down4, 4), (net_s.up1, 3), (net_s.up2, 2), (net_s.up3, 1),
              (net_s.up4, 0)]
    s_convs = sum(gated(b, PATCH >> level) for b, level in blocks)
    s_pools = sum(1 for name, _ in net_s.named_children() if name.startswith("down"))
    deepest = max(select_feature_layers(1))
    seq, vgg_pools = 0, 0
    for c in _CFG:
        if seq > deepest:
            break
        vgg_pools += c == "M"
        seq += 1 if c == "M" else 2
    side, levels = PATCH, 0
    for _ in range(5):  # the default 5-level MS-SSIM
        levels += side >= 11
        side = (side + side % 2) // 2
    steps = -(-n_tiles // BATCH)
    g_steps = TRAIN_EPOCHS[0] * steps
    gs_steps = (TRAIN_EPOCHS[1] + TRAIN_EPOCHS[2]) * steps
    per_step = {"conv3x3": {"g_pretrain": g_convs, "s_init_or_joint": g_convs + s_convs,
                            "inference_chunk": s_convs},
                "pool_bwd": {"g_pretrain": vgg_pools, "s_init_or_joint": s_pools + vgg_pools},
                "fused_ssim": {"step": levels}}
    total = {"conv3x3": g_steps * g_convs + gs_steps * (g_convs + s_convs) + steps * s_convs,
             "pool_bwd": g_steps * vgg_pools + gs_steps * (s_pools + vgg_pools),
             "fused_ssim": (g_steps + gs_steps) * levels}
    return total, per_step


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


def serve_phase(torch, work, smodel):
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.ops.conv3x3 import conv3x3
    from fcdgan_tpu_torch.tools import infer

    argv = ["--dir", work, "--smodel", smodel, "--ref-name", "ref.tif",
            "--batch-size", str(BATCH)]
    conv3x3.launches = 0
    out = infer.main(argv)
    launches = conv3x3.launches
    n_tiles = math.ceil(SCENE / (PATCH - 2 * PAD)) ** 2
    n_chunks = math.ceil(n_tiles / BATCH)
    density = open_raster(out["density_path"]).read_block()[..., 0]
    checks = {
        "density_exists": os.path.isfile(out["density_path"]),
        "color_exists": bool(out["color_path"]) and os.path.isfile(out["color_path"]),
        "density_shape": list(density.shape) == [SCENE, SCENE],
        "density_finite_in_0_1": bool(np.isfinite(density).all()
                                      and density.min() >= 0 and density.max() <= 1),
        "oa_f1_finite": all(isinstance(out.get(k), float) and math.isfinite(out[k])
                            for k in ("oa", "f1")),
        "launches": launches == 3 * n_chunks,
    }
    warm = infer.main(argv)  # same scene again, everything built and cached
    phase("serve", {"px_per_s": out["px_per_s"], "seconds": out["seconds"],
                    "warm_px_per_s": warm["px_per_s"], "warm_seconds": warm["seconds"],
                    "pixels": out["pixels"], "chunks": n_chunks,
                    "conv3x3_launches": launches, "oa": out["oa"], "f1": out["f1"],
                    "auc": out["auc"], "density_mean": float(density.mean()),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    return launches


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


def kernel_counters():
    from fcdgan_tpu_torch.ops.conv3x3 import conv3x3
    from fcdgan_tpu_torch.ops.fused_ssim import ssim_level
    from fcdgan_tpu_torch.ops.pool_bwd import pool_bwd

    return {"conv3x3": conv3x3, "pool_bwd": pool_bwd, "fused_ssim": ssim_level}


def train_phase(torch, work):
    import numpy as np

    from fcdgan_tpu_torch.data.raster import open_raster
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene
    from fcdgan_tpu_torch.demos import demo_usss
    from fcdgan_tpu_torch.io.checkpoint import load_segmentor

    tdir = os.path.join(work, "train")
    make_usss_scene(tdir, TRAIN_SCENE, TRAIN_SCENE, 3, seed=1, dtype="uint16",
                    rects=((150, 200, 120, 90), (600, 450, 150, 210)))
    argv = ["--dir", tdir, "--compute-dtype", "bfloat16", "--batch-size", str(BATCH),
            "--patch-size", f"{PATCH},{PATCH}", "--overlap-padding", f"{PAD},{PAD}",
            "--init-num-epochs-g", str(TRAIN_EPOCHS[0]),
            "--init-num-epochs-s", str(TRAIN_EPOCHS[1]),
            "--num-epochs", str(TRAIN_EPOCHS[2]),
            "--log-tensorboard", "false", "--progress", "false", "--ext", "_smoke"]
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = demo_usss.main(argv)
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want, per_step = derived_launches(torch, out["tiles"])
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
    }
    phase("train", {
        "seconds": seconds, "tiles": out["tiles"],
        "phase_seconds": {"g_pretrain": sum(sec["g"]), "s_init": sum(sec["s"]),
                          "joint": sum(sec["joint"]), "inference": sec["infer"]},
        "joint_epoch_seconds": sec["joint"],
        "joint_epochs_per_s_warm": len(warm) / sum(warm),
        "tile_mpx_per_s_warm": out["tiles"] * PATCH * PATCH * len(warm) / sum(warm) / 1e6,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "derived_launches": want, "per_step": per_step,
        "epoch_metrics": out["epoch_metrics"], **metrics, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")
    return launches, tdir


@contextlib.contextmanager
def record_ssim_levels():
    """Within the block, every MS-SSIM level the port computes is kept in the
    yielded list as (x, y, the level's other arguments, (ssim, cs) tables)."""
    from fcdgan_tpu_torch.ops import ssim as ssim_mod

    orig, levels = ssim_mod._ssim_level, []

    def level(x, y, *args):
        out = orig(x, y, *args)
        levels.append((x.detach(), y.detach(), args, tuple(t.detach() for t in out)))
        return out

    ssim_mod._ssim_level = level
    try:
        yield levels
    finally:
        ssim_mod._ssim_level = orig


def train_parity_phase(torch, tdir):
    """One joint step on 2 tiles in f32 from the same seeded weights, on the
    card (the kernels) and on the CPU (the plain versions). Besides the
    losses, gradient norms and BN stats, the step's own MS-SSIM levels (its
    masked target and generated tiles) are compared before the relu and the
    product: on the card each level's kernel tables against the plain
    version on the same inputs (atol 2e-5), and the card's tables against
    the CPU's (atol 1e-4, as their inputs come from the two devices' G and S
    forwards)."""
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
        net_g, net_s = (type(n)(3) for n in nets0)
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
    phase("train_parity", {"tiles": 2, "losses_cuda": mg, "losses_cpu": mc,
                           "grad_norms_cuda": ng, "grad_norms_cpu": nc,
                           "loss_max_rel": loss_rel, "grad_norm_max_rel": norm_rel,
                           "bn_stats_max_abs": stats_err,
                           "ssim_levels": len(tg),
                           "ssim_tables_cuda": [t.tolist() for t in tg],
                           "ssim_kernel_vs_plain_max_abs": kernel_err,
                           "ssim_tables_cuda_vs_cpu_max_abs": table_err,
                           "tols": {"loss_rel": 1e-4, "grad_norm_rel": 1e-3,
                                    "bn_stats_abs": 1e-4, "ssim_kernel_abs": 2e-5,
                                    "ssim_tables_abs": 1e-4}, "ok": ok})
    if not ok:
        raise AssertionError(f"train parity: losses {loss_rel}, grad norms {norm_rel}, "
                             f"BN stats {stats_err}, {len(tg)} SSIM levels, kernel "
                             f"{kernel_err}, tables {table_err}")


def record(name, source, replaces, rows, launches):
    """One kernel's line of the JSON summary: the sums over its rows of the
    main path's working type (one serving chunk for conv3x3, one training
    step for pool_bwd and fused_ssim)."""
    dt = "bfloat16" if any(r["dtype"] == "bfloat16" for r in rows) else "float32"
    rows = [r for r in rows if r["dtype"] == dt]
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
    lib = [r["library_ms"] for r in rows]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(by, key=by.get),
            "library_ms": None if None in lib else sum(lib)}


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

    work = os.path.join(ROOT, "chiprun_out", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    scene = make_usss_scene(work, SCENE, SCENE, 3, seed=0, dtype="uint16",
                            rects=((300, 400, 250, 180), (1200, 900, 300, 420),
                                   (1700, 1600, 200, 260)))
    smodel, ds, gpu_cache = make_model(torch, work, scene)
    serve_launches = serve_phase(torch, work, smodel)
    parity_phase(torch, smodel, ds, gpu_cache)
    del gpu_cache
    torch.cuda.empty_cache()
    launches, tdir = train_phase(torch, work)
    train_parity_phase(torch, tdir)

    records = [
        record("conv3x3", "fcdgan_tpu_torch/csrc/conv3x3.cu",
               "fcdgan_tpu/ops/pallas/conv3x3.py:103", rows["conv3x3"], launches["conv3x3"]),
        record("pool_bwd", "fcdgan_tpu_torch/csrc/pool_bwd.cu",
               "fcdgan_tpu/ops/pallas/pool_bwd.py:120", rows["pool_bwd"], launches["pool_bwd"]),
        record("fused_ssim", "fcdgan_tpu_torch/csrc/fused_ssim.cu",
               "fcdgan_tpu/ops/pallas/fused_ssim.py:113", rows["fused_ssim"],
               launches["fused_ssim"]),
    ]
    records[0]["serve_launches"] = serve_launches
    summary = {"kernels": records, "card": smi,
               "per_shape": [r for v in rows.values() for r in v],
               "seconds": time.perf_counter() - t_start}
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    shutil.rmtree(work)  # the scenes and rasters: tens of MB
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
