"""Benchmark entry of the port: the modes and JSON lines of the repository's
``bench.py``, measured on the GPU.

Each mode prints one JSON line per metric, ``{"metric", "value", "unit",
"vs_baseline", ...}``, under the JAX bench's metric name and unit, at its
configuration (the reference's production settings; ``FCDGAN_BENCH_DTYPE``,
bf16 by default, picks the compute dtype):

    (default)            usss_driver_joint_epochs_per_s: 20 joint steps of
                         batch 10 at 220 px after 3 warm ones
                         (step_mpx_per_s), then the --driver run
    --driver             usss_driver_joint_epochs_per_s: the joint phase of
                         the driver loop (the driver's feed choice, steps and
                         epoch averages) on a synthetic uint16 scene of
                         --scene-px (1024) px, one warm epoch, --epochs timed
    --inference          usss_infer_throughput_{--density-dtype}: stitched
                         serving of a uint16 scene (FCDGAN_SERVE_BS 32 unless
                         set); vs_baseline = speedup over the float32 download
    --pretrain           usss_pretrain_throughput; vs_baseline = speedup over
                         the same step with the perception target's backward
    --wsss / --rsss      {wsss,rsss}_adversarial_throughput: 20 adversarial
                         steps, batch 15 RGB / 12 four-band pairs of 200 px
    --wsss-driver        wsss_driver_adversarial_epochs_per_s: 150 + 150
                         WHU-shaped slices
    --rsss-driver        rsss_driver_adversarial_epochs_per_s: two 1024 px
                         four-band OSCD scenes
    --batch-sweep        usss_train_throughput_bs{10,20,40,80}: an
                         out-of-memory batch prints value -1 and its error,
                         then its _remat row
    --scaling            usss_dp_scaling_n{1,2,4,8} ms/step, weak scaling at
                         2 tiles of 64 px a rank, one process a rank
                         (``parallel.mesh``), each n in a subprocess;
                         all_reduce_ops counts the collective calls a step

The environment picks the feeds as in the JAX bench: ``FCDGAN_DRIVER_FEED``
(cache, window or stream), ``FCDGAN_DRIVER_DTYPE`` and
``FCDGAN_INFER_DTYPE`` (the scene's raster type), ``FCDGAN_INFER_FEED``
(auto, cache or stream), ``FCDGAN_TAIL``, ``FCDGAN_REMAT``,
``FCDGAN_SERVE_BS``, and ``FCDGAN_OPT`` (the optimizer layout,
``train/optim.py``). Every timed window starts after its warm-up and ends
on ``torch.cuda.synchronize`` or a scalar read. ``vs_baseline`` is -1.0
where the JAX bench divides by an estimate from XLA's cost analysis; the
in-run A/Bs of --inference and --pretrain keep theirs. Every function takes
its sizes as keyword arguments with these defaults, so a CPU run can be
small. Each returns its line's dict as well.

Run on a machine with a CUDA card, from the repository root:

    python -m fcdgan_tpu_torch.tools.bench [--driver | --inference ... | ...]

``--device cpu`` runs a mode on the CPU (sizes as above, so slowly).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh
from ..utils.device import resolve_device

PATCH = 220  # px, the USSS tile (Demo_USSS.py:43)
PAD = (10, 10)
SLICE = 200  # px, the WHU slice and the RSSS tile
# the feed names of the JAX bench's lines, by the port's drivers' names
USSS_FEED = {"resident": "scene_cache", "window": "scene_window", "native_raw": "native_raw",
             "native": "stream", "host": "stream"}


def _emit(result: dict) -> dict:
    print(json.dumps(result), flush=True)
    return result


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def compute_dtype() -> torch.dtype:
    """``FCDGAN_BENCH_DTYPE``: bfloat16 (the default) or float32."""
    name = os.environ.get("FCDGAN_BENCH_DTYPE", "bfloat16")
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"FCDGAN_BENCH_DTYPE must be bfloat16 or float32, not {name!r}")
    return getattr(torch, name)


@contextlib.contextmanager
def _env_default(name: str, value: str):
    """``name`` set to ``value`` for the block when it is unset."""
    had = name in os.environ
    os.environ.setdefault(name, value)
    try:
        yield
    finally:
        if not had:
            os.environ.pop(name, None)


def _perception(per_band: bool):
    from ..models.vgg import select_feature_layers
    from ..train.steps import PerceptionConfig

    dt = compute_dtype()
    return PerceptionConfig(select_feature_layers(1), per_band,
                            dtype=dt if dt == torch.bfloat16 else None)


def _vgg(device):
    from ..models.vgg import VGG16Weights, load_vgg16_params

    return VGG16Weights(load_vgg16_params(), device)


def _nets(nband: int, device, *classes):
    torch.manual_seed(0)
    return [cls(nband, compute_dtype=compute_dtype()).to(device) for cls in classes]


def _on(device, data: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in data.items()}


def usss_setup(device, batch: int = 10, hw: int = PATCH, nband: int = 3,
               msssim_weights: Optional[Sequence[float]] = None,
               interior_sizes: Optional[np.ndarray] = None, remat: Optional[bool] = None,
               pad=PAD):
    """The production USSS joint step (Demo_USSS.py:33-76) and a synthetic
    host batch (bench.py:40-81): seeded full-width G and S, Adam in the
    environment's layout, per-band perception at relu5_3, remat from
    ``FCDGAN_REMAT`` unless ``remat`` is given."""
    from ..models.generator import Generator
    from ..models.segmentor import Segmentor
    from ..train.optim import adam
    from ..train.steps import USSSSteps

    net_g, net_s = _nets(nband, device, Generator, Segmentor)
    if interior_sizes is None:
        interior_sizes = np.tile([[hw - 2 * pad[1], hw - 2 * pad[0]]], (batch, 1))
    if remat is None:
        remat = os.environ.get("FCDGAN_REMAT") == "1"
    steps = USSSSteps(net_g, net_s, adam(net_g.parameters()), adam(net_s.parameters()),
                      _vgg(device), _perception(True), 0.4, 0.65, 0.0, interior_sizes,
                      tuple(pad),
                      msssim_weights=msssim_weights, remat=remat)
    rng = np.random.default_rng(0)
    data = dict(
        x=rng.normal(size=(batch, hw, hw, nband)).astype(np.float32),
        y=rng.normal(size=(batch, hw, hw, nband)).astype(np.float32),
        ref=rng.integers(1, 3, size=(batch, hw, hw, 1)).astype(np.float32),
        item=np.arange(batch, dtype=np.int64),
        weight=np.ones(batch, np.float32))
    return steps, data


def _joint(steps, d, lr=1e-4):
    return steps.joint(d["x"], d["y"], d["ref"], d["item"], d["weight"], lr, lr)


def _timed_steps(step, n: int, device, key: str) -> float:
    """Seconds of ``n`` calls of ``step``, ended by a scalar read of the last
    call's ``key`` metric and a synchronize."""
    t0 = time.perf_counter()
    for _ in range(n):
        m = step()
    float(m[key])
    _sync(device)
    return time.perf_counter() - t0


def main_default(device, batch: int = 10, hw: int = PATCH, warm: int = 3, n_steps: int = 20,
                 msssim_weights: Optional[Sequence[float]] = None, **driver_kw) -> dict:
    """The headline (bench.py:667-782): the joint step alone on a resident
    batch, then the driver run (``bench_driver``), printed as one line."""
    steps, data = usss_setup(device, batch, hw, msssim_weights=msssim_weights)
    d = _on(device, data)
    for _ in range(warm):
        m = _joint(steps, d)
    float(m["NetLoss"])
    dt = _timed_steps(lambda: _joint(steps, d), n_steps, device, "NetLoss")
    step_mpx = batch * hw * hw * n_steps / dt / 1e6
    del steps, d
    out = dict(bench_driver(device, emit=False, batch=batch, patch=hw,
                            msssim_weights=msssim_weights, **driver_kw))
    out.update(step_mpx_per_s=step_mpx, step_vs_baseline=-1.0,
               driver_frac_of_step=out["mpx_per_s"] / step_mpx)
    return _emit(out)


def _budget():
    return {"load_s": 0.0, "put_s": 0.0, "dispatch_s": 0.0, "epoch_sync_s": 0.0}


def _run_epochs(loader, put, step, n_items: int, epochs: int, key: str, budget: dict,
                device):
    """One warm epoch, then ``epochs`` timed ones, as the drivers run an
    epoch: batches read ahead (``prefetch``), placed, stepped, and the
    weighted averages kept on the device and read once an epoch. Returns
    (seconds of the timed epochs, each timed epoch's average of ``key``);
    ``budget`` gets the seconds waiting on the loader, placing, dispatching
    and reading each epoch's averages."""
    from ..data.pipeline import prefetch
    from ..train.loops import EpochAverages

    losses = []

    def epoch(i, timed):
        av = EpochAverages(n_items)
        it = prefetch(iter(loader), 2)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            db = put(batch)
            t2 = time.perf_counter()
            av.update(step(db, i), float(np.asarray(batch["weight"]).sum()))
            t3 = time.perf_counter()
            if timed:
                budget["load_s"] += t1 - t0
                budget["put_s"] += t2 - t1
                budget["dispatch_s"] += t3 - t2
        ts = time.perf_counter()
        value = av[key]  # the epoch's one read: waits for the device
        if timed:
            budget["epoch_sync_s"] += time.perf_counter() - ts
            losses.append(value)

    epoch(0, False)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(epochs):
        epoch(i + 1, True)
    _sync(device)
    return time.perf_counter() - t0, losses


def _per_batch_ms(budget: dict, epochs: int, n_batches: int) -> dict:
    return {k: v / max(epochs, 1) / max(n_batches, 1) * 1e3
            for k, v in budget.items() if k != "epoch_sync_s"}


def bench_driver(device, scene_px: int = 1024, epochs: int = 3, emit: bool = True,
                 batch: int = 10, patch: int = PATCH, pad=PAD,
                 msssim_weights: Optional[Sequence[float]] = None) -> dict:
    """The joint phase of the USSS driver loop (bench.py:217-395): the
    scene through ``demo_usss.scene_feed`` (``FCDGAN_DRIVER_FEED`` cache:
    the driver's own choice; window: the rolling window; stream: the host
    loaders), the joint step, the epoch averages. ``net_losses``: each
    timed epoch's NetLoss."""
    from ..config import USSSConfig
    from ..data.datasets import ScenePairDataset
    from ..data.normalize import Normalize
    from ..data.pipeline import device_put_batch
    from ..data.stats import dataset_meanstd
    from ..data.synthetic import make_usss_scene
    from ..demos.demo_usss import scene_feed
    from ..train.schedules import JOINT_USSS

    feed_env = os.environ.get("FCDGAN_DRIVER_FEED", "cache")
    scene_cache = {"cache": "auto", "window": "window", "stream": "off"}.get(feed_env)
    if scene_cache is None:
        raise ValueError(f"FCDGAN_DRIVER_FEED must be cache, window or stream, not {feed_env!r}")
    scene_dt = os.environ.get("FCDGAN_DRIVER_DTYPE", "uint16")
    with tempfile.TemporaryDirectory() as td:
        paths = make_usss_scene(td, scene_px, scene_px, 3, dtype=scene_dt)
        stats_ds = ScenePairDataset(paths["x"], paths["y"], patch_size=(patch, patch),
                                    overlap_padding=(0, 0))
        scaler = Normalize(*dataset_meanstd(os.path.join(td, "s1.txt"),
                                            os.path.join(td, "s2.txt"), stats_ds))
        dataset = ScenePairDataset(paths["x"], paths["y"], ref_path=paths["ref"],
                                   enhance=scaler, patch_size=(patch, patch),
                                   overlap_padding=tuple(pad))
        steps, _ = usss_setup(device, batch, patch, msssim_weights=msssim_weights,
                              interior_sizes=dataset.grid.interior_sizes(), pad=pad)
        cfg = USSSConfig(batch_size=batch, seed=0, scene_cache=scene_cache,
                         tail=os.environ.get("FCDGAN_TAIL", "short"), device=str(device))
        feed, cache, loader, placer = scene_feed(cfg, dataset, scaler, device)

        def put(b):
            if cache is not None:
                return cache.complete(b)
            db = device_put_batch(b, device)
            return placer(db) if placer is not None else db

        def step(db, i):
            lr = JOINT_USSS(i)
            return steps.joint(db["x"], db["y"], db["ref"], db["item"], db["weight"], lr, lr)

        budget = _budget()
        dt, losses = _run_epochs(loader, put, step, len(dataset), epochs, "NetLoss", budget,
                                 device)
        mpx = len(dataset) * patch * patch * epochs / dt / 1e6
        result = {
            "metric": "usss_driver_joint_epochs_per_s", "value": epochs / dt,
            "unit": "epochs/s", "vs_baseline": -1.0, "scene_px": scene_px,
            "tiles_per_epoch": len(dataset), "batches_per_epoch": len(loader),
            "mpx_per_s": mpx, "feed": USSS_FEED[feed], "device_normalize": placer is not None,
            "scene_dtype": scene_dt,
            "budget_ms_per_batch": _per_batch_ms(budget, epochs, len(loader)),
            "epoch_sync_ms": budget["epoch_sync_s"] / max(epochs, 1) * 1e3,
            "net_losses": losses}
        if feed == "window":
            ws = cache.drain_slab_waits()
            waits = [w for _, _, w in ws]
            result["slab_waits"] = {"n": len(waits), "total_s": sum(waits),
                                    "max_s": max(waits) if waits else 0.0,
                                    "over_100ms": [(t, k, w) for t, k, w in ws if w > 0.1]}
    return _emit(result) if emit else result


def bench_inference(device, density_dtype: str = "float32", scene_px: int = 1024,
                    patch: int = PATCH, pad=PAD, batch: int = 10, reps: int = 3,
                    chain: int = 20) -> dict:
    """Full-scene stitched serving px/s (bench.py:84-215) through
    ``eval.inference.stitched_inference`` with an eval-mode seeded
    Segmentor: a warm pass, then ``reps`` timed ones (a pass under 35 % of
    the best is set aside, logged, and replaced, up to three times), the
    median reported; the float32 download first, as the baseline.
    ``device_compute_mpx_per_s``: ``chain`` forwards of one batch, each
    input depending on the last output, no host I/O."""
    from ..data.datasets import ScenePairDataset
    from ..data.synthetic import make_usss_scene
    from ..eval.inference import nhwc_infer, stitched_inference
    from ..models.segmentor import Segmentor

    torch.manual_seed(0)
    model = Segmentor(3, compute_dtype=torch.bfloat16).to(device).eval()
    feed = os.environ.get("FCDGAN_INFER_FEED", "auto")
    scene_dt = os.environ.get("FCDGAN_INFER_DTYPE", "uint16")
    with tempfile.TemporaryDirectory() as td, _env_default("FCDGAN_SERVE_BS", "32"):
        paths = make_usss_scene(td, scene_px, scene_px, 3, dtype=scene_dt)

        def one_pass(dd):
            ds = ScenePairDataset(paths["x"], paths["y"],
                                  out_path=os.path.join(td, f"density_{dd}.tif"),
                                  patch_size=(patch, patch), overlap_padding=tuple(pad))
            _sync(device)
            t0 = time.time()
            st = stitched_inference(ds, model, batch, device, device_feed=feed,
                                    density_dtype=dd)
            return {"px_per_s": st["px_per_s"], "t_start": t0, "wall_s": time.time() - t0,
                    "feed": st["feed"]}

        def run(dd):
            one_pass(dd)  # warm: kernels built, cuDNN's choices made
            runs, stalls = [one_pass(dd) for _ in range(reps)], []
            for _ in range(3):
                best = max(r["px_per_s"] for r in runs)
                slow = [r for r in runs if r["px_per_s"] < 0.35 * best]
                if not slow:
                    break
                runs.remove(slow[0])
                stalls.append(slow[0])
                runs.append(one_pass(dd))
            runs.sort(key=lambda r: r["px_per_s"])
            info = {"reps_mpx_per_s": [r["px_per_s"] / 1e6 for r in runs],
                    "rep_wall_s": [r["wall_s"] for r in runs],
                    "rep_t_start": [r["t_start"] for r in runs],
                    "stalls_discarded": [{"mpx_per_s": r["px_per_s"] / 1e6,
                                          "wall_s": r["wall_s"], "t_start": r["t_start"]}
                                         for r in stalls]}
            return runs[len(runs) // 2], info

        base, base_info = run("float32")
        stats, info = (base, base_info) if density_dtype == "float32" else run(density_dtype)

    infer = nhwc_infer(model)
    rng = np.random.default_rng(0)
    xb, yb = (torch.from_numpy(rng.normal(size=(batch, patch, patch, 3)).astype(np.float32))
              .to(device) for _ in range(2))

    @torch.no_grad()
    def chained():
        acc = torch.zeros((), device=device)
        for _ in range(chain):
            acc = acc + infer(xb + acc, yb).float().mean()
        return float(acc)

    chained()
    t0 = time.perf_counter()
    chained()
    compute_mpx = chain * batch * patch * patch / (time.perf_counter() - t0) / 1e6
    return _emit({
        "metric": f"usss_infer_throughput_{density_dtype}",
        "value": stats["px_per_s"] / 1e6, "unit": "Mpx/s",
        "vs_baseline": stats["px_per_s"] / base["px_per_s"], **info,
        "f32_reps_mpx_per_s": base_info["reps_mpx_per_s"], "feed": feed,
        "served_feed": stats["feed"], "scene_dtype": scene_dt,
        "serve_bs": os.environ.get("FCDGAN_SERVE_BS", "32"),
        "device_compute_mpx_per_s": compute_mpx})


def _pretrain_stacked(steps, x, y, w, lr):
    """``USSSSteps.g_pretrain`` with the perception target's backward kept
    (the stacked both-branch pass, bench.py:471-489): the A/B baseline."""
    from ..train.optim import set_lr

    steps.G.train()
    cmap = torch.zeros(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
    gen, l1, perc, ssim = steps._cnet_ck(y, steps._g_fwd(x), cmap, w)
    loss = gen + steps.pw * perc + steps.sw * ssim
    steps.opt_g.zero_grad(set_to_none=True)
    loss.backward()
    set_lr(steps.opt_g, lr)
    steps.opt_g.step()
    return {"NetLoss": loss.detach()}


def bench_pretrain(device, batch: int = 10, hw: int = PATCH, n_steps: int = 20,
                   msssim_weights: Optional[Sequence[float]] = None) -> dict:
    """USSS G-pretrain step Mpx/s (bench.py:397-468): the port's
    ``g_pretrain`` (the target branch forward only) against the stacked
    baseline, each on its own fresh nets, one warm step each."""
    def measure(step_fn):
        steps, data = usss_setup(device, batch, hw, msssim_weights=msssim_weights)
        d = _on(device, data)
        float(step_fn(steps, d)["NetLoss"])
        dt = _timed_steps(lambda: step_fn(steps, d), n_steps, device, "NetLoss")
        return batch * hw * hw * n_steps / dt / 1e6

    fast = measure(lambda s, d: s.g_pretrain(d["x"], d["y"], d["weight"], 1e-4))
    slow = measure(lambda s, d: _pretrain_stacked(s, d["x"], d["y"], d["weight"], 1e-4))
    return _emit({"metric": "usss_pretrain_throughput", "value": fast, "unit": "Mpx/s",
                  "vs_baseline": fast / slow, "stacked_target_grad_mpx_s": slow})


def wsss_setup(device, batch: int = 15, hw: int = SLICE, nband: int = 3,
               msssim_weights: Optional[Sequence[float]] = None):
    """The production WSSS adversarial step (Demo_WSSS.py:31-66,
    bench.py:505-535) and its synthetic device arguments."""
    from ..models.discriminator import Discriminator
    from ..models.generator import Generator
    from ..models.segmentor import Segmentor
    from ..train.optim import adam, rmsprop
    from ..train.steps import WSSSSteps

    net_g, net_s, net_d = _nets(nband, device, Generator, Segmentor, Discriminator)
    steps = WSSSSteps(net_g, net_s, net_d, adam(net_g.parameters()),
                      rmsprop(net_s.parameters()), rmsprop(net_d.parameters()), _vgg(device),
                      _perception(False), 0.5, 0.0, 0.2, 1.6, 1.0, 1.5, 0.6,
                      msssim_weights=msssim_weights)
    rng = np.random.default_rng(0)

    def mk():
        return rng.normal(size=(batch, hw, hw, nband)).astype(np.float32)

    c_x, c_y = mk(), mk()
    c_ref = rng.integers(0, 2, size=(batch, hw, hw, 1)).astype(np.float32)
    nc_x, nc_y = mk(), mk()
    d = _on(device, dict(c_x=c_x, c_y=c_y, c_ref=c_ref, nc_x=nc_x, nc_y=nc_y,
                         w=np.ones(batch, np.float32)))
    return steps, (d["c_x"], d["c_y"], d["c_ref"], d["nc_x"], d["nc_y"], d["w"], 1e-3, 1e-5)


def rsss_setup(device, batch: int = 12, hw: int = SLICE, nband: int = 4,
               msssim_weights: Optional[Sequence[float]] = None,
               interior_sizes: Optional[np.ndarray] = None, pad=PAD):
    """The production RSSS adversarial step (Demo_RSSS.py:31-67,
    bench.py:561-605; RMSprop for all three nets, as there) and its
    synthetic device arguments."""
    from ..models.discriminator import Discriminator
    from ..models.generator import Generator
    from ..models.segmentor import Segmentor
    from ..train.optim import rmsprop
    from ..train.steps import RSSSSteps

    net_g, net_s, net_d = _nets(nband, device, Generator, Segmentor, Discriminator)
    if interior_sizes is None:
        interior_sizes = np.tile([[hw - 2 * pad[1], hw - 2 * pad[0]]], (batch, 1))
    steps = RSSSSteps(net_g, net_s, net_d, rmsprop(net_g.parameters()),
                      rmsprop(net_s.parameters()), rmsprop(net_d.parameters()), _vgg(device),
                      _perception(True), 0.1, 0.0, 0.5, 0.02, 1.0, 2.0, interior_sizes,
                      tuple(pad),
                      msssim_weights=msssim_weights)
    rng = np.random.default_rng(0)

    def mk():
        return rng.normal(size=(batch, hw, hw, nband)).astype(np.float32)

    x, y = mk(), mk()
    ref = rng.integers(1, 3, size=(batch, hw, hw, 1)).astype(np.float32)
    region = rng.integers(0, 2, size=(batch, hw, hw, 1)).astype(np.float32)
    d = _on(device, dict(x=x, y=y, ref=ref, region=region,
                         item=np.arange(batch, dtype=np.int64), w=np.ones(batch, np.float32)))
    return steps, (d["x"], d["y"], d["ref"], d["region"], d["item"], d["w"], 5e-5, 5e-5)


def _adversarial_mpx(steps, args, px_per_step: int, n_steps: int, device) -> float:
    """Mpx/s of ``n_steps`` adversarial steps after one warm step
    (bench.py:470-485)."""
    float(steps.adversarial(*args)["s_loss"])
    dt = _timed_steps(lambda: steps.adversarial(*args), n_steps, device, "s_loss")
    return px_per_step * n_steps / dt / 1e6


def bench_wsss(device, batch: int = 15, hw: int = SLICE, n_steps: int = 20,
               msssim_weights: Optional[Sequence[float]] = None) -> dict:
    """WSSS adversarial-step Mpx/s, both pairs of each step counted
    (bench.py:505-556)."""
    steps, args = wsss_setup(device, batch, hw, msssim_weights=msssim_weights)
    mpx = _adversarial_mpx(steps, args, 2 * batch * hw * hw, n_steps, device)
    return _emit({"metric": "wsss_adversarial_throughput", "value": mpx, "unit": "Mpx/s",
                  "vs_baseline": -1.0})


def bench_rsss(device, batch: int = 12, hw: int = SLICE, n_steps: int = 20,
               msssim_weights: Optional[Sequence[float]] = None) -> dict:
    """RSSS adversarial-step Mpx/s (bench.py:561-617)."""
    steps, args = rsss_setup(device, batch, hw, msssim_weights=msssim_weights)
    mpx = _adversarial_mpx(steps, args, batch * hw * hw, n_steps, device)
    return _emit({"metric": "rsss_adversarial_throughput", "value": mpx, "unit": "Mpx/s",
                  "vs_baseline": -1.0})


def _driver_result(metric: str, epochs: int, dt: float, px_per_epoch: int, budget: dict,
                   n_batches: int, step_mpx: float, extra: dict) -> dict:
    """An adversarial driver mode's line (bench.py:618-638)."""
    mpx = px_per_epoch * epochs / dt / 1e6
    return {"metric": metric, "value": epochs / dt, "unit": "epochs/s", "vs_baseline": -1.0,
            "mpx_per_s": mpx, "step_mpx_per_s": step_mpx,
            "driver_frac_of_step": mpx / step_mpx if step_mpx else -1.0,
            "budget_ms_per_batch": _per_batch_ms(budget, epochs, n_batches),
            "epoch_sync_ms": budget["epoch_sync_s"] / max(epochs, 1) * 1e3, **extra}


def bench_wsss_driver(device, epochs: int = 3, n_pairs: int = 150, hw: int = SLICE,
                      batch: int = 15, n_steps: int = 20,
                      msssim_weights: Optional[Sequence[float]] = None) -> dict:
    """The adversarial phase of the WSSS driver loop (bench.py:640-790) on
    ``n_pairs`` changed and ``n_pairs`` unchanged synthetic WHU slices: the
    pairs through ``demo_wsss.slice_feed`` (``FCDGAN_DRIVER_FEED`` cache:
    the driver's choice; anything else: the host loaders), re-paired each
    epoch; ``step_mpx_per_s`` is the same step on resident tensors."""
    from ..config import WSSSConfig
    from ..data.datasets import WHUDataset, WHUPairDataset
    from ..data.normalize import Normalize
    from ..data.stats import dataset_meanstd
    from ..data.synthetic import make_whu_dataset
    from ..demos.demo_wsss import _put, slice_feed
    from ..train import schedules

    feed_env = os.environ.get("FCDGAN_DRIVER_FEED", "cache")
    with tempfile.TemporaryDirectory() as td:
        paths = make_whu_dataset(td, n_changed=n_pairs, n_unchanged=n_pairs, size=hw)
        dirs = (paths["before"], paths["after"], paths["Label"], td)
        scaler = Normalize(*dataset_meanstd(
            os.path.join(paths["before"], "stats_meanstd.txt"),
            os.path.join(paths["after"], "stats_meanstd.txt"), WHUDataset(*dirs, "-1")))
        pair_ds = WHUPairDataset(*dirs, scale=scaler, random_assign=False,
                                 rng=random.Random(0))
        cfg = WSSSConfig(img_dir_x=dirs[0], img_dir_y=dirs[1], ref_dir=dirs[2],
                         label_dir=td, batch_size=batch, seed=0,
                         slice_cache="auto" if feed_env == "cache" else "off",
                         tail=os.environ.get("FCDGAN_TAIL", "short"), device=str(device))
        feed, _, cache, loader, _ = slice_feed(cfg, pair_ds, scaler, device)
        steps, args = wsss_setup(device, batch, hw, msssim_weights=msssim_weights)

        def put(b):
            if cache is not None:
                return cache.complete_pair(b)
            return _put(b, ("c_x", "c_y", "c_ref", "nc_x", "nc_y", "weight"), device)

        def step(db, i):
            return steps.adversarial(db["c_x"], db["c_y"], db["c_ref"], db["nc_x"], db["nc_y"],
                                     db["weight"], schedules.S_ADV_WSSS(i),
                                     schedules.D_ADV_WSSS(i))

        budget = _budget()
        total = len(pair_ds)
        dt, losses = _run_epochs(loader, put, step, total, epochs, "s_loss", budget, device)
        step_mpx = _adversarial_mpx(steps, args, 2 * batch * hw * hw, n_steps, device)
    return _emit(_driver_result(
        "wsss_driver_adversarial_epochs_per_s", epochs, dt, 2 * total * hw * hw, budget,
        len(loader), step_mpx,
        {"pairs_per_epoch": total, "batches_per_epoch": len(loader),
         "feed": "slice_cache" if cache is not None else feed, "s_losses": losses}))


def bench_rsss_driver(device, epochs: int = 3, scene_px: int = 1024, hw: int = SLICE,
                      batch: int = 12, n_steps: int = 20, pad=PAD,
                      msssim_weights: Optional[Sequence[float]] = None) -> dict:
    """The adversarial phase of the RSSS driver loop without its test
    evaluation (bench.py:796-950) on two synthetic four-band OSCD scenes of
    ``scene_px`` px with per-scene normalizers: the resident tile stacks
    (``FCDGAN_DRIVER_FEED`` cache, when they fit), else the driver's host
    loaders; ``step_mpx_per_s`` is the same step on resident tensors."""
    from ..data.datasets import OSCDDataset
    from ..data.device_cache import DeviceOSCDCache
    from ..data.pipeline import NativeOSCDBatchLoader
    from ..data.synthetic import make_oscd_dataset
    from ..demos.demo_rsss import FIELDS, _loader, _scene_scalers
    from ..data.pipeline import device_put_batch
    from ..train import schedules

    nband = 4
    feed_env = os.environ.get("FCDGAN_DRIVER_FEED", "cache")
    with tempfile.TemporaryDirectory() as td:
        make_oscd_dataset(td, train_scenes=("alpha", "beta"), test_scenes=(), xsize=scene_px,
                          ysize=scene_px, nband=nband)
        dataset = OSCDDataset(td, "train.txt",
                              scaler=_scene_scalers(td, "train.txt", (hw, hw), "statsMS"),
                              patch_size=(hw, hw), overlap_padding=tuple(pad))
        total = len(dataset)
        cache = (DeviceOSCDCache(dataset, device)
                 if feed_env == "cache" and DeviceOSCDCache.supports(dataset) else None)
        feed = ("tile_cache" if cache is not None
                else "native" if NativeOSCDBatchLoader.supports(dataset) else "host")
        loader = _loader(feed, dataset, cache, batch, True, 1,
                         os.environ.get("FCDGAN_TAIL", "short"))
        steps, args = rsss_setup(device, batch, hw, nband, msssim_weights=msssim_weights,
                                 interior_sizes=dataset.interior_sizes(), pad=pad)

        def put(b):
            if cache is not None:
                return cache.complete(b)
            return device_put_batch({k: b[k] for k in FIELDS + ("weight",)}, device)

        def step(db, i):
            return steps.adversarial(db["x"], db["y"], db["ref"], db["region"], db["item"],
                                     db["weight"], schedules.S_ADV_RSSS(i),
                                     schedules.D_ADV_RSSS(i))

        budget = _budget()
        dt, losses = _run_epochs(loader, put, step, total, epochs, "s_loss", budget, device)
        step_mpx = _adversarial_mpx(steps, args, batch * hw * hw, n_steps, device)
    return _emit(_driver_result(
        "rsss_driver_adversarial_epochs_per_s", epochs, dt, total * hw * hw, budget,
        len(loader), step_mpx,
        {"tiles_per_epoch": total, "batches_per_epoch": len(loader), "scene_px": scene_px,
         "feed": feed, "s_losses": losses}))


def bench_batch_sweep(device, batches: Sequence[int] = (10, 20, 40, 80), hw: int = PATCH,
                      n_steps: int = 10, msssim_weights: Optional[Sequence[float]] = None
                      ) -> list:
    """Joint-step Mpx/s at each batch (bench.py:952-1001). A batch past the
    card's memory prints value -1 with the error, and is tried again with
    remat (``_remat``); the sweep goes on to the next batch."""
    def measure(bs, remat):
        steps, data = usss_setup(device, bs, hw, msssim_weights=msssim_weights, remat=remat)
        d = _on(device, data)
        float(_joint(steps, d)["NetLoss"])
        dt = _timed_steps(lambda: _joint(steps, d), n_steps, device, "NetLoss")
        return bs * hw * hw * n_steps / dt / 1e6

    rows = []
    for bs in batches:
        for remat, suffix in ((None, ""), (True, "_remat")):
            name = f"usss_train_throughput_bs{bs}{suffix}"
            error = None
            try:
                rows.append(_emit({"metric": name, "value": measure(bs, remat),
                                   "unit": "Mpx/s", "vs_baseline": -1.0}))
            except torch.cuda.OutOfMemoryError as e:
                error = type(e).__name__
            if error is None:
                break
            gc.collect()  # the failed attempt's tensors, before the next one
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            rows.append(_emit({"metric": name, "value": -1.0, "unit": "Mpx/s",
                               "vs_baseline": -1.0, "error": error}))
    return rows


def _scaling_rank(device: str, batch_per_rank: int, hw: int, msssim_weights, reps: int
                  ) -> dict:
    """One rank of a weak-scaling point: its slice of the global batch, one
    warm step whose collective calls are counted, then ``reps`` timed."""
    n = mesh.world()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.device(device).type == "cuda" else torch.device("cpu"))
    steps, data = usss_setup(dev, batch_per_rank * n, hw, msssim_weights=msssim_weights)
    d = _on(dev, mesh.shard_batch(data))
    calls = mesh.collective_calls()
    float(_joint(steps, d)["NetLoss"])
    calls = mesh.collective_calls() - calls
    mesh.barrier()
    dt = _timed_steps(lambda: _joint(steps, d), reps, dev, "NetLoss")
    return {"metric": f"usss_dp_scaling_n{n}", "value": dt / reps * 1e3, "unit": "ms/step",
            "vs_baseline": -1.0, "all_reduce_ops": calls, "devices": n,
            "global_batch": batch_per_rank * n}


def bench_scaling_worker(n: int, device: str = "cuda", batch_per_rank: int = 2,
                         hw: int = 64, msssim_weights=(0.5, 0.5), reps: int = 5) -> dict:
    """One point of ``--scaling`` (bench.py:1003-1064): ``n`` ranks
    (``mesh.launch``: one per GPU over NCCL, or gloo ranks on the CPU)."""
    return _emit(mesh.launch(_scaling_rank, n, device, device, batch_per_rank, hw,
                             msssim_weights, reps))


def bench_scaling(device, ns: Sequence[int] = (1, 2, 4, 8), timeout: float = 1800.0,
                  **worker_kw) -> list:
    """Weak scaling, each n in a subprocess of its own with a timeout. On
    the GPU an n past the card count prints value -1 with ``need n devices,
    have k``, as the JAX mode's rows of a failed point do."""
    device = str(device)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    rows = []
    for n in ns:
        row = {"metric": f"usss_dp_scaling_n{n}", "value": -1.0, "unit": "ms/step",
               "vs_baseline": -1.0}
        have = torch.cuda.device_count()
        if torch.device(device).type == "cuda" and n > have:
            rows.append(_emit({**row, "error": f"need {n} devices, have {have}"}))
            continue
        if torch.device(device).type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()  # this process's cached blocks, which a worker cannot use
        cmd = [sys.executable, "-m", "fcdgan_tpu_torch.tools.bench", "--scaling-worker",
               str(n), "--device", device, "--worker-kw", json.dumps(worker_kw)]
        try:
            out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                                 timeout=timeout)
            lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
            rows.append(_emit(json.loads(lines[-1]) if lines and out.returncode == 0
                              else {**row, "error": out.stderr.strip()[-300:]}))
        except subprocess.TimeoutExpired:
            rows.append(_emit({**row, "error": f"timed out after {timeout:g} s"}))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--inference", action="store_true")
    ap.add_argument("--density-dtype", default="float32",
                    choices=["float32", "bfloat16", "uint8"])
    ap.add_argument("--scene-px", type=int, default=1024)
    ap.add_argument("--driver", action="store_true", help="USSS driver joint epochs/s")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--pretrain", action="store_true",
                    help="USSS G-pretrain step throughput and its target-grad A/B")
    ap.add_argument("--wsss", action="store_true", help="WSSS adversarial-step throughput")
    ap.add_argument("--rsss", action="store_true", help="RSSS adversarial-step throughput")
    ap.add_argument("--wsss-driver", action="store_true",
                    help="WSSS driver adversarial epochs/s")
    ap.add_argument("--rsss-driver", action="store_true",
                    help="RSSS driver adversarial epochs/s")
    ap.add_argument("--batch-sweep", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--scaling-worker", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--worker-kw", default="{}", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.scaling_worker:
        return bench_scaling_worker(args.scaling_worker, args.device,
                                    **json.loads(args.worker_kw))
    if args.scaling:
        return bench_scaling(device)
    if args.inference:
        return bench_inference(device, args.density_dtype, args.scene_px)
    if args.driver:
        return bench_driver(device, args.scene_px, args.epochs)
    if args.pretrain:
        return bench_pretrain(device)
    if args.wsss:
        return bench_wsss(device)
    if args.rsss:
        return bench_rsss(device)
    if args.wsss_driver:
        return bench_wsss_driver(device, args.epochs)
    if args.rsss_driver:
        return bench_rsss_driver(device, args.epochs, args.scene_px)
    if args.batch_sweep:
        return bench_batch_sweep(device)
    return main_default(device, scene_px=args.scene_px, epochs=args.epochs)


if __name__ == "__main__":
    main()
