"""Where the time of one training step goes on the GPU: a torch.profiler window.

``--mode usss`` (the default) builds the training configuration of
``chip_smoke.py``'s train phase (a synthetic 1024x1024 3-band uint16 scene,
patch 220, padding 10, batch 10, bf16, seeded full-width Generator and
Segmentor, the random VGG16, per-band perception at relu5_3) and profiles a
joint step. ``--mode wsss`` builds that of its wsss phase (synthetic 200x200
RGB uint8 WHU slices, batch 15 pairs, bf16, seeded Generator, Segmentor and
Discriminator, RGB perception at relu5_3) and profiles an adversarial step.
``--mode rsss`` builds that of its rsss phase (a synthetic OSCD scene of
1024x1024 4-band uint16, patch 200, padding 10, batch 12, bf16, seeded
4-band Generator, Segmentor and Discriminator, per-band perception at
relu5_3, the RSSS loss weights) and profiles an adversarial step on tiles
that hold a region. Each mode runs four warm steps (the kernels build, cuDNN picks its
algorithms), times ``--steps`` more with a synchronize after each, then runs
one step under ``torch.profiler``. Prints one JSON line: the step's wall
time with and without the profiler, the device's busy time and idle share
over the profiled step, device time by coarse group (the kernels of the
port, the other convolutions forward and backward, BN/elementwise, pooling
and upsampling, the optimizer, gather/copy) and by kernel name (top
``--top``), and the layout copies (the recorder's counter
``layout.nhwc_copies``, ``ops/layout.py``) the step made before its
kernels. On a card the USSS joint step is a CUDA graph by then
(``train.steps.StepGraphs``): the profiled step is a replay
(``graph_replay``), whose kernels the trace shows without the host's
ops, and whose layout copies, counted on the host, read null.
``--n-devices 1`` runs the step in a world of one (``parallel.mesh``:
NCCL, every all-reduce of a data-parallel step): ``allreduce_calls``
counts them; over one rank NCCL copies device to device (``dtod_copies``)
where a larger world launches its kernels (the "nccl all-reduce" group,
``nccl_kernels``).

Run on a machine with a CUDA card, from the repository root:

    python -m fcdgan_tpu_torch.tools.profile_train [--mode wsss|rsss] [--steps 8] \
        [--n-devices 1]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import statistics
import tempfile
import time

import numpy as np
import torch

from ..parallel import mesh
from ..utils.timing import recording
from .profile_serve import device_summary

WSSS_SIZE = 200  # px, the side of a WHU Building CD slice
RSSS_PATCH = 200  # px, the RSSS tile (Demo_RSSS.py:43)

GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("nccl all-reduce", ("nccl",)),
    ("conv3x3 kernel", ("conv3x3_wgmma_kernel", "conv3x3_fma_kernel")),
    ("pool_bwd kernel", ("pool_bwd_nhwc_kernel",)),
    ("phase_pool kernel", ("phase_pool_nhwc_kernel",)),
    ("channel_sums kernels (BN statistics)", ("channel_sums_kernel",)),
    ("fused_ssim kernel", ("ssim_level_kernel",)),
    ("cudnn/cutlass conv fwd+bwd", ("conv", "xmma", "implicit", "cutlass", "sm90_",
                                    "gemm", "wgrad", "dgrad", "nchwtonhwc",
                                    "nhwctonchw")),
    ("optimizer", ("multi_tensor", "adam")),
    ("pool/upsample", ("pool", "upsample", "interp")),
    ("gather/copy/cat", ("index", "gather", "copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise/BN/reduce", ("elementwise", "vectorized", "reduce", "addcmul", "relu",
                               "sigmoid", "where", "batch_norm")),
)


def _usss_step(device, batch_size, scene):
    from ..data.datasets import ScenePairDataset
    from ..data.device_cache import DeviceSceneCache
    from ..data.normalize import Normalize
    from ..data.stats import dataset_meanstd
    from ..data.synthetic import make_usss_scene
    from ..models.generator import Generator
    from ..models.segmentor import Segmentor
    from ..models.vgg import VGG16Weights, load_vgg16_params
    from ..train.optim import adam
    from ..train.steps import PerceptionConfig, USSSSteps

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as work:
        make_usss_scene(work, scene, scene, 3, seed=1, dtype=np.uint16)
        stats_ds = ScenePairDataset(os.path.join(work, "T1.tif"), os.path.join(work, "T2.tif"),
                                    patch_size=(220, 220), overlap_padding=(0, 0))
        scaler = Normalize(*dataset_meanstd(os.path.join(work, "s1.txt"),
                                            os.path.join(work, "s2.txt"), stats_ds))
        ds = ScenePairDataset(os.path.join(work, "T1.tif"), os.path.join(work, "T2.tif"),
                              ref_path=os.path.join(work, "ref.tif"), enhance=scaler,
                              patch_size=(220, 220), overlap_padding=(10, 10))
        cache = DeviceSceneCache(ds, scaler, device)
    torch.manual_seed(0)
    net_g = Generator(3, compute_dtype=torch.bfloat16).to(device)
    net_s = Segmentor(3, compute_dtype=torch.bfloat16).to(device)
    steps = USSSSteps(net_g, net_s, adam(net_g.parameters()), adam(net_s.parameters()),
                      VGG16Weights(load_vgg16_params(), device),
                      PerceptionConfig((29,), True, dtype=torch.bfloat16),
                      0.4, 0.65, 0.0, ds.grid.interior_sizes(), (10, 10))
    batch = {"item": np.arange(batch_size), "weight": np.ones(batch_size, np.float32)}

    def step():
        db = cache.complete(batch)
        return steps.joint(db["x"], db["y"], db["ref"], db["item"], db["weight"], 1e-4, 1e-4)

    return step, batch_size


def _wsss_step(device, batch_size):
    from ..data.datasets import WHUPairDataset
    from ..data.device_cache import DeviceWHUCache
    from ..data.normalize import Normalize
    from ..data.stats import dataset_meanstd
    from ..data.synthetic import make_whu_dataset
    from ..models.discriminator import Discriminator
    from ..models.generator import Generator
    from ..models.segmentor import Segmentor
    from ..models.vgg import VGG16Weights, load_vgg16_params
    from ..train import schedules
    from ..train.optim import adam, rmsprop
    from ..train.steps import PerceptionConfig, WSSSSteps

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as work:
        make_whu_dataset(work, batch_size, batch_size, WSSS_SIZE, seed=2)
        dirs = [os.path.join(work, d) for d in ("before", "after", "Label")] + [work]
        scaler = Normalize(*dataset_meanstd(os.path.join(work, "s1.txt"),
                                            os.path.join(work, "s2.txt"),
                                            WHUPairDataset(*dirs).c_ds))
        pair_ds = WHUPairDataset(*dirs, scale=scaler, rng=random.Random(0))
        cache = DeviceWHUCache(pair_ds, scaler, device)
    torch.manual_seed(0)
    dt = torch.bfloat16
    net_g, net_s, net_d = (cls(3, compute_dtype=dt).to(device)
                           for cls in (Generator, Segmentor, Discriminator))
    steps = WSSSSteps(net_g, net_s, net_d, adam(net_g.parameters()),
                      rmsprop(net_s.parameters()), rmsprop(net_d.parameters()),
                      VGG16Weights(load_vgg16_params(), device),
                      PerceptionConfig((29,), False, dtype=dt), 0.5, 0.0, 0.2, 1.6, 1.0, 1.5)
    items = np.arange(batch_size)
    batch = {"c_item": items, "nc_item": items, "weight": np.ones(batch_size, np.float32)}
    lr_s, lr_d = schedules.S_ADV_WSSS(2), schedules.D_ADV_WSSS(2)

    def step():
        db = cache.complete_pair(batch)
        return steps.adversarial(db["c_x"], db["c_y"], db["c_ref"], db["nc_x"], db["nc_y"],
                                 db["weight"], lr_s, lr_d)

    return step, batch_size


def _rsss_step(device, batch_size, scene):
    from ..data.datasets import OSCDDataset
    from ..data.device_cache import DeviceOSCDCache
    from ..data.synthetic import make_oscd_dataset
    from ..demos.demo_rsss import _scene_scalers
    from ..models.discriminator import Discriminator
    from ..models.generator import Generator
    from ..models.segmentor import Segmentor
    from ..models.vgg import VGG16Weights, load_vgg16_params
    from ..train import schedules
    from ..train.optim import adam, rmsprop
    from ..train.steps import PerceptionConfig, RSSSSteps

    patch = (RSSS_PATCH, RSSS_PATCH)
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as work:
        make_oscd_dataset(work, ("alpha",), (), scene, scene, 4, region_expand=40, seed=3,
                          rects=((150, 180, 120, 90), (600, 420, 150, 210)), dtype=np.uint16)
        ds = OSCDDataset(work, "train.txt", _scene_scalers(work, "train.txt", patch, "statsMS"),
                         patch_size=patch, overlap_padding=(10, 10))
        cache = DeviceOSCDCache(ds, device)
        items = [i for i in range(len(ds)) if ds[i][4].any()]
    torch.manual_seed(0)
    dt = torch.bfloat16
    net_g, net_s, net_d = (cls(4, compute_dtype=dt).to(device)
                           for cls in (Generator, Segmentor, Discriminator))
    steps = RSSSSteps(net_g, net_s, net_d, adam(net_g.parameters()),
                      rmsprop(net_s.parameters()), rmsprop(net_d.parameters()),
                      VGG16Weights(load_vgg16_params(), device),
                      PerceptionConfig((29,), True, dtype=dt), 0.1, 0.0, 0.5, 0.02, 1.0, 2.0,
                      ds.interior_sizes(), (10, 10))
    batch = {"item": np.resize(np.asarray(items), batch_size),
             "weight": np.ones(batch_size, np.float32)}
    lr_s, lr_d = schedules.S_ADV_RSSS(2), schedules.D_ADV_RSSS(2)

    def step():
        db = cache.complete(batch)
        return steps.adversarial(db["x"], db["y"], db["ref"], db["region"], db["item"],
                                 db["weight"], lr_s, lr_d)

    return step, batch_size


def main(argv=None) -> dict:
    """Profile the step that ``argv`` names; print and return its summary."""
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("usss", "wsss", "rsss"), default="usss")
    ap.add_argument("--scene", type=int, default=1024, help="usss, rsss: scene side in px")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="tiles (usss, default 10; rsss, default 12) or pairs (wsss, "
                         "default 15) per step")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--n-devices", type=int, default=0, choices=(0, 1),
                    help="1: the step in a world of one, with its all-reduces")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    with contextlib.ExitStack() as stack:
        if args.n_devices:
            store = stack.enter_context(tempfile.TemporaryDirectory())
            stack.enter_context(mesh.world_group(0, 1, "file://" + os.path.join(store, "rdv"),
                                                 torch.device("cuda", 0)))
        out = _profile(args, device)
    print(json.dumps(out))
    return out


def _profile(args, device) -> dict:
    if args.mode == "usss":
        run, bs = _usss_step(device, args.batch_size or 10, args.scene)
    elif args.mode == "rsss":
        run, bs = _rsss_step(device, args.batch_size or 12, args.scene)
    else:
        run, bs = _wsss_step(device, args.batch_size or 15)

    def step():
        m = run()
        torch.cuda.synchronize(device)
        return m

    for _ in range(4):
        step()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    wall, prof, copies = profiled_step(step, device)
    return {
        "device": torch.cuda.get_device_name(device), "mode": args.mode,
        "n_devices": args.n_devices, **collectives(prof),
        "batch_size": bs, "scene": None if args.mode == "wsss" else args.scene,
        "slice": WSSS_SIZE if args.mode == "wsss" else None,
        "step_ms_unprofiled": [t * 1e3 for t in times],
        "step_ms_unprofiled_median": statistics.median(times) * 1e3,
        "step_ms_profiled": wall * 1e3,
        "graph_replay": copies is None,
        "layout_copies_per_step": copies,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        **device_summary(prof, wall, groups=GROUPS, top=args.top),
    }


def profiled_step(step, device):
    """One ``step()`` under ``torch.profiler`` (CPU activities, and CUDA
    ones on a card) and the recorder: its wall seconds, the profiler, and
    the layout copies it made (``layout.nhwc_copies``), None when it was a
    CUDA graph's replay (``step.graph_replays``), which makes none on the
    host."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with recording() as rec, profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        wall = time.perf_counter() - t0
    if rec.counters.get("step.graph_replays", 0):
        return wall, prof, None
    return wall, prof, rec.counters.get("layout.nhwc_copies", 0)


def collectives(prof) -> dict:
    """The all-reduce calls of a profiler window, the NCCL kernels, and the
    device-to-device copies (NCCL over one rank copies instead of launching
    a kernel; other copies are the step's own): counts and device ms."""
    out = {"allreduce_calls": 0, "nccl_kernels": 0, "nccl_kernel_ms": 0.0,
           "dtod_copies": 0, "dtod_copy_ms": 0.0}
    for ev in prof.events():
        name = ev.name.lower()
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            out["allreduce_calls"] += name in ("nccl:all_reduce", "gloo:all_reduce")
        elif "nccl" in name:
            out["nccl_kernels"] += 1
            out["nccl_kernel_ms"] += ev.time_range.elapsed_us() / 1e3
        elif name.startswith("memcpy dtod"):
            out["dtod_copies"] += 1
            out["dtod_copy_ms"] += ev.time_range.elapsed_us() / 1e3
    return out


if __name__ == "__main__":
    main()
