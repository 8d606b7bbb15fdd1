"""Unsupervised change detection driver (reference: Demo_USSS.py).

Port of the JAX package's ``demos/demo_usss.py``: stats pass -> normalized
tile dataset -> G pretrain -> S init -> joint alternating (G-gradient
accumulation) -> stitched inference of the whole scene -> the
change-density GeoTIFF, the {TN,FN,FP,TP} color raster and the metrics ->
``SModel{ext}.pkl`` / ``GModel{ext}.pkl`` (reference state_dicts, so
``tools/infer.py`` serves the trained S as it stands) and ``Para_*.txt``.

The feed is the JAX driver's choice (demo_usss.py:88-160), named in the
result's ``feed``: ``resident`` (the scene pair on the device,
``--scene-cache auto|on``), else ``window`` (the rolling-window slabs of a
scene past ``FCDGAN_SCENE_CACHE_MAX_MB``, or ``--scene-cache window``), else
the native loader's raw tiles normalized on the device (``native_raw``,
``--device-normalize auto|on``) or its float32 tiles (``native``), else the
Python ``BatchLoader`` (``host``). The caches run the fused stitched
inference; the host feeds run the tile loop, whose downloads a writer thread
stitches.

Run (on the GPU unless ``--device cpu``):

    python -m fcdgan_tpu_torch.demos.demo_usss --dir /data --ext _run1

``run`` returns the JAX driver's result dict (demo_usss.py:445-455), with
the trained modules under ``sstate`` / ``gstate`` and, in addition, each
epoch's averaged metrics (``epoch_metrics``) and the wall seconds of every
epoch of each phase and of the inference (``epoch_seconds``), each ending
when its metrics reached the host.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from .. import native
from ..config import USSSConfig, parse_cli, unported
from ..data.datasets import ScenePairDataset
from ..data.device_cache import DeviceSceneCache, DeviceSceneWindowCache
from ..data.normalize import Normalize
from ..data.pipeline import (BatchLoader, DeviceNormalizer, NativeSceneBatchLoader,
                             device_put_batch, prefetch)
from ..data.raster import create_raster
from ..data.stats import dataset_meanstd
from ..eval.changemap import write_changemap_gdal
from ..eval.evaluator import Evaluator
from ..eval.inference import nhwc_infer, run_overlapped
from ..eval.roc import RocCurve
from ..io.checkpoint import save_net
from ..io.records import (ScalarWriter, segmentation_summary, timestamped_para_path,
                          write_para_txt)
from ..models.generator import Generator
from ..models.segmentor import Segmentor
from ..models.vgg import VGG16Weights, load_vgg16_params, select_feature_layers
from ..train import schedules
from ..train.loops import EpochAverages, Progress, accuracy_line
from ..train.optim import adam
from ..train.steps import PerceptionConfig, USSSSteps
from ..utils.device import resolve_device
from ..utils.download import Download

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LOSS_KEYS = ("NetLoss", "generator_loss", "l1_loss", "perception_loss", "ssim_loss")
LOSS_LABELS = ("NetLoss Loss", "generator_loss Loss", "l1_loss Loss",
               "perception_loss", "ssim_loss")


def _check_supported(cfg: USSSConfig) -> None:
    missing = unported(cfg)
    if missing:
        raise NotImplementedError(
            "not ported to fcdgan_tpu_torch yet: {}; see ROADMAP.md (queue A, "
            "'Training: what the USSS slice leaves out')".format("; ".join(missing)))
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute-dtype must be one of {sorted(_DTYPES)}")
    for name, value, values in (("scene-cache", cfg.scene_cache, ("auto", "on", "window", "off")),
                                ("device-normalize", cfg.device_normalize, ("auto", "on", "off"))):
        if value not in values:
            raise ValueError(f"--{name} must be one of {values}, not {value!r}")


def scene_feed(cfg: USSSConfig, dataset, scaler, device):
    """(feed name, cache or None, loader, placer or None) of the JAX
    driver's choice (demo_usss.py:88-160): the resident scene, else the
    rolling window, else the native loader (raw tiles with a
    ``DeviceNormalizer`` placer when it can), else ``BatchLoader``.
    ``--scene-cache on|window`` and ``--device-normalize on`` raise when they
    cannot be met."""
    cache = None
    if cfg.scene_cache != "off":
        if cfg.scene_cache != "window" and DeviceSceneCache.supports(dataset):
            cache, feed = DeviceSceneCache(dataset, scaler, device), "resident"
        elif DeviceSceneWindowCache.supports(dataset):
            cache, feed = DeviceSceneWindowCache(dataset, scaler, device), "window"
    if cfg.scene_cache in ("on", "window") and cache is None:
        raise RuntimeError(
            "--scene-cache {}: needs a Normalize enhance and the scene (or one tile-row "
            "slab) within FCDGAN_SCENE_CACHE_MAX_MB / FCDGAN_SCENE_WINDOW_MB".format(
                cfg.scene_cache))
    if cache is not None:
        return feed, cache, cache.loader(cfg.batch_size, shuffle=True, seed=cfg.seed), None
    placer = None
    if all(native.can_open(r.path) for r in (dataset.raster_x, dataset.raster_y)):
        raw = (cfg.device_normalize != "off"
               and NativeSceneBatchLoader.supports_device_normalize(dataset))
        loader = NativeSceneBatchLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                        device_normalize=raw)
        feed = "native_raw" if raw else "native"
        if raw:
            placer = DeviceNormalizer(scaler, dataset.size()[2], device)
    else:
        loader = BatchLoader(dataset, cfg.batch_size, fields=("x", "y", "item", "ref"),
                             shuffle=True, seed=cfg.seed, tail="short")
        feed = "host"
    if cfg.device_normalize == "on" and feed != "native_raw":
        raise RuntimeError("--device-normalize on: needs the native loader and a shared "
                           "integral raster dtype ({})".format(
                               native.build_error() or "the rasters do not allow it"))
    return feed, None, loader, placer


def _log_accuracy(writer: ScalarWriter, ev: Evaluator, step: int, prefix: str = ""):
    miou, ciou = ev.Mean_Intersection_over_Union()
    for tag, value in (("Overall Accuracy:", ev.Pixel_Accuracy()),
                       ("Precision Rate", ev.Pixel_Precision_Rate()),
                       ("Recall Rate", ev.Pixel_Recall_Rate()),
                       ("Kappa Coefficient:", ev.Pixel_Kappa()),
                       ("F1", ev.Pixel_F1_score()), ("mIOU", miou), ("cIOU", ciou)):
        writer.add_scalar(prefix + tag, value, step)


def run(cfg: USSSConfig) -> Dict:
    _check_supported(cfg)
    device = resolve_device(cfg.device)
    dtype = _DTYPES[cfg.compute_dtype]
    torch.manual_seed(cfg.seed)
    outdir = cfg.outdir or cfg.dir
    os.makedirs(outdir, exist_ok=True)
    img_x = os.path.join(cfg.dir, cfg.image_x_name)
    img_y = os.path.join(cfg.dir, cfg.image_y_name)
    ref_path = os.path.join(cfg.dir, cfg.ref_name)
    stem1, ext1 = os.path.splitext(cfg.image_x_name)
    stem2, _ = os.path.splitext(cfg.image_y_name)
    cmap_name = "{}{}".format(cfg.cmap_name, cfg.ext)
    out_path = os.path.join(outdir, cmap_name + ext1)
    out_color_path = os.path.join(outdir, "{}_acc_color{}".format(cmap_name, ext1))

    # -- stats pass + normalizer (Demo_USSS.py:88-95) -----------------------
    stats_ds = ScenePairDataset(img_x, img_y, patch_size=cfg.patch_size,
                                overlap_padding=(0, 0))
    sp1 = os.path.join(cfg.dir, "{}_{}.txt".format(stem1, cfg.stats_name))
    sp2 = os.path.join(cfg.dir, "{}_{}.txt".format(stem2, cfg.stats_name))
    scaler = Normalize(*dataset_meanstd(sp1, sp2, stats_ds))
    dataset = ScenePairDataset(img_x, img_y, ref_path=ref_path, out_path=out_path,
                               enhance=scaler, patch_size=cfg.patch_size,
                               overlap_padding=cfg.overlap_padding)
    total = len(dataset)
    feed, cache, loader, placer = scene_feed(cfg, dataset, scaler, device)

    def put(batch):
        if cache is not None:
            return cache.complete(batch)
        db = device_put_batch(batch, device)
        return placer(db) if placer is not None else db

    # -- models / steps (Demo_USSS.py:110-122) -------------------------------
    nband = dataset.size()[2]
    net_g = Generator(nband, compute_dtype=dtype).to(device)
    net_s = Segmentor(nband, compute_dtype=dtype).to(device)
    vgg = VGG16Weights(load_vgg16_params(cfg.vgg_npz, require=cfg.require_vgg), device)
    steps = USSSSteps(
        net_g, net_s, adam(net_g.parameters()), adam(net_s.parameters()), vgg,
        PerceptionConfig(select_feature_layers(cfg.perception_layer),
                         cfg.perception_per_band,
                         dtype=dtype if dtype == torch.bfloat16 else None),
        cfg.perception_weight, cfg.l1_weight, cfg.ssim_weight,
        dataset.grid.interior_sizes(), cfg.overlap_padding, cfg.gt_map, cfg.pre_map,
        cfg.prob_thresh, cfg.msssim_weights, ssim_metric=cfg.ssim_metric)
    writer = ScalarWriter(comment="USSS{}".format(cfg.ext), enabled=cfg.log_tensorboard)
    seconds = {"g": [], "s": [], "joint": [], "infer": 0.0}
    metrics = {"g": [], "s": [], "joint": []}

    def epoch(phase, i, n_epochs, step_fn, first_step):
        t0 = time.perf_counter()
        av = EpochAverages(total)
        prog = Progress(total, lambda: n_epochs - 1 - i, cfg.progress)
        for batch in prefetch(iter(loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put(batch)
            av.update(step_fn(db), float(batch["weight"].sum()))
            prog.end_batch(int(batch["weight"].sum()))
        prog.finish()
        print("Epochs: {}/{}, {}".format(i + 1, n_epochs, ", ".join(
            "{}: {:.4f}".format(lbl, av[k]) for lbl, k in zip(LOSS_LABELS, LOSS_KEYS))))
        for k in LOSS_KEYS:
            writer.add_scalar(k, av[k], first_step + i)
        if phase != "g":
            ev = av.evaluator(len(cfg.gt_map))
            print(accuracy_line(i, n_epochs, ev))
            _log_accuracy(writer, ev, first_step + i)
        seconds[phase].append(time.perf_counter() - t0)
        metrics[phase].append(av.as_dict())

    # -- phase 1: generator init (Demo_USSS.py:124-189) ---------------------
    print("Start Initial Generator Training")
    for i in range(cfg.init_num_epochs_g):
        lr = schedules.G_PRETRAIN(i / cfg.lr_epoch_scale) * cfg.lr_scale
        epoch("g", i, cfg.init_num_epochs_g,
              lambda db: steps.g_pretrain(db["x"], db["y"], db["weight"], lr), 0)

    # -- phase 2: segmentor init (Demo_USSS.py:192-286) ---------------------
    print("Start Initial Segmentor Training")
    for i in range(cfg.init_num_epochs_s):
        lr = schedules.S_INIT_USSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        epoch("s", i, cfg.init_num_epochs_s,
              lambda db: steps.s_init(db["x"], db["y"], db["ref"], db["item"],
                                      db["weight"], lr), cfg.init_num_epochs_g)

    # -- phase 3: joint alternating (Demo_USSS.py:289-400) ------------------
    print("Start Training")
    for i in range(cfg.num_epochs):
        lr = schedules.JOINT_USSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        epoch("joint", i, cfg.num_epochs,
              lambda db: steps.joint(db["x"], db["y"], db["ref"], db["item"],
                                     db["weight"], lr, lr),
              cfg.init_num_epochs_g + cfg.init_num_epochs_s)

    # -- stitched inference + write-back (Demo_USSS.py:404-473) -------------
    print("Saving Change Map and Model")
    print("Segmentation of Change")
    t0 = time.perf_counter()
    acc = Evaluator(num_class=len(cfg.gt_map))
    roc = RocCurve()
    if cache is not None:
        _fused_inference(cfg, cache, steps, dataset, acc, roc, out_color_path)
    else:
        _tile_inference(cfg, steps, dataset, acc, roc, out_color_path, device)
    seconds["infer"] = time.perf_counter() - t0
    dataset.close_outputs()
    print(segmentation_summary(acc))
    print("AUC: {:.4f}".format(roc.auc()))
    print("End of Saving", flush=True)

    # -- checkpoints + Para txt (Demo_USSS.py:477-501) ----------------------
    smodel_path = os.path.join(outdir, "SModel{}.pkl".format(cfg.ext))
    gmodel_path = os.path.join(outdir, "GModel{}.pkl".format(cfg.ext))
    if cfg.save_checkpoints:
        save_net(smodel_path, net_s)
        save_net(gmodel_path, net_g)
    writer.close()
    para_path = timestamped_para_path(outdir, cfg.ext)
    write_para_txt(para_path, {
        "perception_weight": cfg.perception_weight,
        "ssim_weight": cfg.ssim_weight,
        "perception_perBand": cfg.perception_per_band,
        "perception_layer": cfg.perception_layer,
        "l1_weight": cfg.l1_weight,
        "discriminator_continuous": cfg.discriminator_continuous,
        "prob_thresh": cfg.prob_thresh,
    }, acc=acc, tips=cfg.tips)
    return {
        "evaluator": acc,
        "auc": roc.auc(),
        "density_path": out_path,
        "color_path": out_color_path if cfg.write_color else None,
        "para_path": para_path,
        "smodel_path": smodel_path if cfg.save_checkpoints else None,
        "gmodel_path": gmodel_path if cfg.save_checkpoints else None,
        "sstate": net_s,
        "gstate": net_g,
        "epoch_metrics": metrics,
        "epoch_seconds": seconds,
        "tiles": total,
        "feed": feed,
        "n_slabs": cache.n_slabs if feed == "window" else None,
        "slab_waits": cache.slab_waits if feed == "window" else None,
    }


def _fused_inference(cfg, cache, steps, dataset, acc, roc, out_color_path) -> None:
    """The whole scene through the cache's fused stitched pass (resident or
    window); color raster and metrics over the full arrays (tile interiors
    tile the scene disjointly)."""
    density = cache.stitched_density(steps.infer, batch_size=cfg.batch_size)
    dataset.write_full(density)
    cmask_full = (density > cfg.prob_thresh).astype(np.int16)
    ref_full = np.zeros_like(cmask_full)
    if dataset.raster_ref is not None:
        ref_full = dataset.raster_ref.read_block()[..., 0].astype(np.int16)
    if cfg.write_color:
        xs, ys, _ = dataset.size()
        codes = write_changemap_gdal(cmask_full[None], ref_full[None], write_color=True,
                                     ref_map=cfg.gt_map, dt_map=cfg.pre_map)
        with create_raster(out_color_path, xs, ys, 1, np.int32,
                           like=dataset.raster_x) as out_color:
            out_color.write_block(codes[0].astype(np.int32), 0, 0, band=0)
    acc.add_batch_map(ref_full, cmask_full, list(cfg.gt_map), list(cfg.pre_map))
    roc.add_batch(density, ref_full == cfg.gt_map[1])


def _tile_inference(cfg, steps, dataset, acc, roc, out_color_path, device) -> None:
    """The tile loop of the host feeds (JAX demo_usss.py:357-438): host tiles
    from ``BatchLoader`` through the eval-mode S, each download stitched by a
    writer thread into the density and color rasters, the metrics over each
    tile's interior."""
    loader = BatchLoader(dataset, cfg.batch_size, fields=("x", "y", "item", "ref"),
                         shuffle=False)
    infer = nhwc_infer(steps.infer)
    out_color = None
    processed = 0
    total = len(dataset)

    def compute(batch):
        db = device_put_batch({"x": batch["x"], "y": batch["y"]}, device)
        return Download(infer(db["x"], db["y"]))

    def process(dl: Download, batch):
        nonlocal out_color, processed
        cmap = dl.result().float().numpy()
        cmask = (cmap > cfg.prob_thresh).astype(np.int16)
        for ns in range(len(batch["weight"])):
            if batch["weight"][ns] == 0:
                continue
            item = int(batch["item"][ns])
            dataset.write_default(cmap[ns], item)
            ref_chw = np.moveaxis(batch["ref"][ns], -1, 0)
            cmask_chw = np.moveaxis(cmask[ns], -1, 0)
            if cfg.write_color:
                if out_color is None:
                    xs, ys, _ = dataset.size()
                    out_color = create_raster(out_color_path, xs, ys, 1, np.int32,
                                              like=dataset.raster_x)
                codes = write_changemap_gdal(cmask_chw, ref_chw, write_color=True,
                                             ref_map=cfg.gt_map, dt_map=cfg.pre_map)
                dataset.write(np.moveaxis(codes, 0, -1).astype(np.int32), item, out_color)
            y0, y1, x0, x1 = dataset.grid.interior(item)
            acc.add_batch_map(ref_chw[0, y0:y1, x0:x1].astype(np.int16),
                              cmask_chw[0, y0:y1, x0:x1].astype(np.int16),
                              list(cfg.gt_map), list(cfg.pre_map))
            roc.add_batch(cmap[ns, y0:y1, x0:x1, 0], ref_chw[0, y0:y1, x0:x1] == cfg.gt_map[1])
        processed += int(np.asarray(batch["weight"]).sum())
        if cfg.progress:
            print("\rProcessing batch: {}/{}".format(processed, total), end="", flush=True)

    run_overlapped(prefetch(iter(loader), cfg.prefetch_depth), compute, process)
    if cfg.progress:
        print("\r", end="", flush=True)
    if out_color is not None:
        out_color.close()


def main(argv=None) -> Dict:
    return run(parse_cli(USSSConfig, argv))


if __name__ == "__main__":
    main()
