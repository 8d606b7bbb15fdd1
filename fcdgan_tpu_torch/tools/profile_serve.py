"""Where the time of scene serving goes on the GPU: a torch.profiler window.

Makes a synthetic scene pair (``data/synthetic.py``) and a seeded full-width
Segmentor, runs ``tools.infer`` once (its px/s, stats caches, kernel build),
then times the scene upload, warms the device pass and runs it again under
``torch.profiler``: every chunk's gather, Segmentor and canvas writes, and
the one download. Prints one JSON line: the pass's wall time with and
without the profiler, the device's busy time and idle share over the
profiled pass, and device time by kernel name (top ``--top``) and by coarse
group (the conv3x3 kernel, other convolutions, elementwise/BN,
pooling/upsampling, gather/copy).

Run on a machine with a CUDA card, from the repository root:

    python -m fcdgan_tpu_torch.tools.profile_serve [--scene 2048] [--batch-size 10]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("conv3x3 kernel", ("conv3x3_nhwc_kernel",)),
    ("cudnn/cutlass conv", ("conv", "xmma", "implicit", "cutlass", "sm90_", "gemm",
                            "nchwtonhwc", "nhwctonchw")),
    ("pool/upsample", ("pool", "upsample", "interp")),
    ("gather/copy/cat", ("index", "gather", "copy", "cat", "memcpy", "memset",
                         "fill")),
    ("elementwise/BN", ("elementwise", "vectorized", "addcmul", "relu",
                        "sigmoid", "where", "reduce")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile

    from ..data.datasets import ScenePairDataset
    from ..data.device_cache import DeviceSceneCache
    from ..data.normalize import Normalize
    from ..data.stats import dataset_meanstd
    from ..data.synthetic import make_usss_scene
    from ..io.checkpoint import load_segmentor, save_net
    from ..models.segmentor import Segmentor
    from ..tools.infer import InferConfig, run
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as work:
        make_usss_scene(work, args.scene, args.scene, 3, seed=0, dtype=np.uint16)
        torch.manual_seed(0)
        save_net(os.path.join(work, "SModel.pkl"), Segmentor(3))
        cfg = InferConfig(dir=work, smodel=os.path.join(work, "SModel.pkl"),
                          ref_name="ref.tif", batch_size=args.batch_size)
        out = run(cfg)  # the whole tool once: stats caches, kernel build
        stats = Normalize(*dataset_meanstd(os.path.join(work, "T1_stats.txt"),
                                           os.path.join(work, "T2_stats.txt"), None))
        ds = ScenePairDataset(os.path.join(work, "T1.tif"), os.path.join(work, "T2.tif"),
                              enhance=stats, patch_size=cfg.patch_size,
                              overlap_padding=cfg.overlap_padding)
        net = load_segmentor(cfg.smodel, device=device, compute_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        cache = DeviceSceneCache(ds, stats, device)
        torch.cuda.synchronize(device)
        upload_ms = (time.perf_counter() - t0) * 1e3
        cache.stitched_density(net, args.batch_size)  # warm
        torch.cuda.synchronize(device)
        # the window: the device pass over every chunk and the one download
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cache.stitched_density(net, args.batch_size)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        cache.stitched_density(net, args.batch_size)
        unprofiled = time.perf_counter() - t0

    by_name = {}
    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
            spans.append((ev.time_range.start, ev.time_range.end))
    busy = 0.0
    end = -1.0
    for s, e in sorted(spans):  # union of kernel intervals, in us
        if e > end:
            busy += e - max(s, end)
            end = e
    groups = {}
    for name, ms in by_name.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]
    print(json.dumps({
        "device": torch.cuda.get_device_name(device), "scene": args.scene,
        "batch_size": args.batch_size, "chunks": -(-len(ds) // args.batch_size),
        "tool_px_per_s": out["px_per_s"], "tool_seconds": out["seconds"],
        "upload_ms": upload_ms, "pass_ms_unprofiled": unprofiled * 1e3,
        "pass_ms_profiled": wall * 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - (busy / 1e3) / (wall * 1e3),
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[name[:90], ms] for name, ms in top],
    }))


if __name__ == "__main__":
    main()
