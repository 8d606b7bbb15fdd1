#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

  device   the card's name and power limit (nvidia-smi)
  build    nvcc builds every kernel source of the port (all started together)
  kernels  conv3x3 at the three serving shapes of one chunk (patch 220,
           batch 10 stacked to 20), bf16 and f32: max abs error against
           conv3x3_plain on the card and its tolerance, median ms of the
           kernel, of the plain version and of F.conv2d (the library call,
           timed here only), the bound, and what bounds it
  serve    tools.infer.main on a 2048x2048 3-band uint16 scene with a seeded
           full-width Segmentor (bf16): output rasters, density in [0, 1],
           finite oa/f1, conv3x3 launched 3 times per chunk; px_per_s
  parity   one chunk of 2 tiles through the port in f32 on the card and on
           the CPU (plain versions): max abs density difference <= 1e-3

Then one JSON line of kernel records, and as the last line
{"ok": true, "device": {...}}. f32 comparisons run with TF32 off (cuDNN and
cuBLAS), set once for the whole script. The scratch files go to
chiprun_out/chip_smoke/ inside the checkout.
"""

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
SCENE = 2048
BATCH = 10
PATCH = 220
PAD = 10


def phase(name, payload):
    print(name, json.dumps(payload), flush=True)


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
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
    logs = build.build(["conv3x3"])
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    phase("build", {"seconds": time.perf_counter() - t0, "ptxas": ptxas})


def kernels_phase(torch, F):
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
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
            row = {
                "name": "conv3x3", "layer": layer, "dtype": dtype_name,
                "shape": [n, h, w, ci, co], "max_abs_err": err, "tol": tol,
                "library_max_abs_err": lib_err,
                "ms": cuda_ms(torch, lambda: conv3x3(x, k)),
                "plain_ms": cuda_ms(torch, lambda: conv3x3_plain(x, k), reps=5),
                "library_ms": cuda_ms(torch, lambda: F.conv2d(x_nchw, k_oihw, padding=1)),
                "bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            phase("kernels", row)
            if not err <= tol:
                raise AssertionError(f"conv3x3 {layer} {dtype_name}: max abs err "
                                     f"{err} > tol {tol}")
            rows.append(row)
            del x, k, got, want, lib
    torch.cuda.empty_cache()
    return rows


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
    rows = kernels_phase(torch, F)

    work = os.path.join(ROOT, "chiprun_out", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    scene = make_usss_scene(work, SCENE, SCENE, 3, seed=0, dtype="uint16",
                            rects=((300, 400, 250, 180), (1200, 900, 300, 420),
                                   (1700, 1600, 200, 260)))
    smodel, ds, gpu_cache = make_model(torch, work, scene)
    launches = serve_phase(torch, work, smodel)
    parity_phase(torch, smodel, ds, gpu_cache)

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    t_bytes = sum(r["bytes"] for r in bf16) / PEAK_BYTES * 1e3
    t_ops = sum(r["flops"] for r in bf16) / PEAK_FLOPS["bfloat16"] * 1e3
    record = {
        "name": "conv3x3", "route": "cuda",
        "source": "fcdgan_tpu_torch/csrc/conv3x3.cu",
        "replaces": "fcdgan_tpu/ops/pallas/conv3x3.py:103",
        "launches": launches,
        # one serving chunk's three launches in bf16, summed
        "max_abs_err": max(r["max_abs_err"] for r in bf16),
        "ms": sum(r["ms"] for r in bf16),
        "plain_ms": sum(r["plain_ms"] for r in bf16),
        "bound_ms": sum(r["bound_ms"] for r in bf16),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in bf16),
    }
    summary = {"kernels": [record], "card": smi, "per_shape": rows,
               "seconds": time.perf_counter() - t_start}
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    shutil.rmtree(work)  # the scene and rasters: tens of MB
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
