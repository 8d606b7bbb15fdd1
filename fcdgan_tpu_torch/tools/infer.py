"""Stitched inference from a saved SModel state_dict (the serving tool).

Port of the JAX package's ``tools/infer.py`` on one device. Load
``SModel*.pkl`` and run the eval-mode Segmentor in one of three modes:

  * ``scene`` (:114-310): one raster pair over the overlap-tiled grid
    (parity: reference data_utils.py:57-63,154-176), stitched into the
    change-density GeoTIFF and, when a reference raster is given, the
    {TN,FN,FP,TP} color raster and the metrics (Demo_USSS.py:404-473
    semantics). ``--device-feed auto`` keeps the pair resident on the GPU
    and runs the whole pass there with one download, when the scene fits
    ``FCDGAN_SCENE_CACHE_MAX_MB``; otherwise, and with ``stream`` or
    ``cache``, tiles go through the device batch by batch while a writer
    thread stitches the downloads (``eval/inference.stitched_inference``).
  * ``whu`` (:325-440): a WHU slice set to per-slice eval and density
    images (Demo_WSSS.py:387-445); ``--bn-mode train`` is the reference's
    train-mode-BN inference, with S's statistics from each batch's real
    slices and its running buffers moving from batch to batch.
  * ``oscd`` (:443-637): an RSSS scene list to per-scene density and color
    (or binary) rasters in each scene's ``ImagePair/`` (Demo_RSSS.py:
    449-504), fused per scene with two scenes in flight, or streamed.

``--density-dtype uint8|bfloat16`` quantizes the downloads on the device.
``FCDGAN_SERVE_BS`` above 0 widens the fused pass's chunks (``main`` sets
it to 32 unless it is set, as the JAX tool does; ``run`` leaves it as
found). ``--siamese-stats split`` (ROADMAP.md A.3) and ``--n-devices`` above
1 (A.4) are not ported and raise ``NotImplementedError``.

Run:
  python -m fcdgan_tpu_torch.tools.infer --dir /data --smodel SModel.pkl \\
      [--ref-name ref.tif] [--density-dtype uint8] [--device cpu]
  python -m fcdgan_tpu_torch.tools.infer --mode oscd --dir /oscd --smodel SModel.pkl
  python -m fcdgan_tpu_torch.tools.infer --mode whu --smodel SModel.pkl \\
      --img-dir-x W/before --img-dir-y W/after --ref-dir W/Label --label-dir W \\
      [--bn-mode train]

Normalization stats are read from (or computed into) the same caches the
training demos use (``{image}_stats.txt``, oscd ``{image}_statsMS.txt``, whu
``stats_meanstd.txt``), so data prepared for training serves unchanged. An
orbax ``SModel.ckpt`` from the JAX package is converted first with
``python -m fcdgan_tpu.tools.convert_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch


def _json_line(d: Dict) -> str:
    """Strict JSON: non-finite metrics become null, not bare NaN tokens."""
    def clean(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        return v

    return json.dumps({k: clean(v) for k, v in d.items() if k != "evaluator"})


@dataclasses.dataclass
class InferConfig:
    mode: str = "scene"                 # 'scene' | 'whu' (slice set) | 'oscd' (scene list)
    dir: str = "."
    smodel: str = ""                    # path to SModel*.pkl (required)
    image_x_name: str = "T1.tif"
    image_y_name: str = "T2.tif"
    # -- oscd mode (Demo_RSSS.py:449-504) -----------------------------------
    txt_name: str = "test.txt"          # one-line comma-separated scene list
    out_name_density: str = "density_serve"
    out_name_binary: str = "color_serve"
    # -- whu mode (Demo_WSSS.py:387-445) ------------------------------------
    img_dir_x: str = ""
    img_dir_y: str = ""
    ref_dir: str = ""
    label_dir: str = ""
    label_selected: str = "1"           # '1' changed / '0' unchanged / '-1' listed / '-2' all
    write_grey: bool = True             # per-slice density images (cmap * 255)
    bn_mode: str = "eval"               # whu: 'train' = the reference's train-mode BN
    ref_name: str = ""                  # optional: enables metrics + color map
    outdir: str = ""                    # default: dir
    cmap_name: str = "ChangeDensity"
    ext: str = ""
    stats_name: str = ""                # '' = 'statsMS' for oscd, 'stats' otherwise
    patch_size: Tuple[int, int] = (220, 220)
    overlap_padding: Tuple[int, int] = (10, 10)
    batch_size: int = 10
    gt_map: Tuple[int, int] = (1, 2)
    pre_map: Tuple[int, int] = (0, 1)
    prob_thresh: float = 0.5
    write_color: bool = True
    bilinear: bool = True
    device: str = "cuda"                # 'cpu' only on request
    compute_dtype: str = "bfloat16"     # serving default; 'float32' for parity
    siamese_stats: str = "joint"        # must match the checkpoint's training
    density_dtype: str = "float32"      # uint8/bfloat16 = quantized download
    device_feed: str = "auto"           # 'auto' fused resident | 'cache' | 'stream'
    transfer_dtype: str = ""            # streamed uploads, e.g. 'bfloat16'
    prefetch_depth: int = 2
    n_devices: int = 0                  # multi-device serving is not ported
    progress: bool = True


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to fcdgan_tpu_torch yet; see "
                               f"ROADMAP.md, queue A, item {item}")


def _check_supported(cfg: InferConfig) -> None:
    from ..eval.inference import transfer_type
    from ..utils.download import check_density_dtype

    if cfg.siamese_stats == "split":
        raise _not_ported("--siamese-stats split (per-branch BN statistics)", "A.3")
    if cfg.n_devices > 1:
        raise _not_ported("multi-device serving (--n-devices)", "A.4")
    if cfg.mode not in ("scene", "whu", "oscd"):
        raise ValueError(f"--mode must be scene, whu or oscd, not {cfg.mode!r}")
    if cfg.siamese_stats != "joint":
        raise ValueError(f"--siamese-stats must be joint or split, not {cfg.siamese_stats!r}")
    if cfg.bn_mode not in ("eval", "train"):
        raise ValueError(f"--bn-mode must be eval or train, not {cfg.bn_mode!r}")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute-dtype must be one of {sorted(_DTYPES)}")
    if cfg.device_feed not in ("auto", "cache", "stream"):
        raise ValueError(f"--device-feed must be auto, cache or stream, not {cfg.device_feed!r}")
    check_density_dtype(cfg.density_dtype)
    transfer_type(cfg.transfer_dtype)


def _segmentor(cfg: InferConfig, device: torch.device, nband: int):
    """The eval-mode Segmentor of ``--smodel`` on ``device``, checked against
    the data's band count (JAX ``_restore_segmentor``, :96-111)."""
    from ..io.checkpoint import load_segmentor

    if not cfg.smodel:
        raise SystemExit("--smodel <SModel.pkl> is required")
    net = load_segmentor(cfg.smodel, device=device, compute_dtype=_DTYPES[cfg.compute_dtype],
                         bilinear=cfg.bilinear)
    if net.inc.double_conv[0].in_channels != nband:
        raise ValueError(f"{cfg.smodel} takes {net.inc.double_conv[0].in_channels} "
                         f"bands, the data has {nband}")
    return net


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _progress(cfg: InferConfig, done: int, total: int) -> None:
    if cfg.progress:
        print("\rProcessing batch: {}/{}".format(done, total), end="", flush=True)


def run(cfg: InferConfig) -> Dict:
    from ..utils.device import resolve_device

    _check_supported(cfg)
    device = resolve_device(cfg.device)
    if not cfg.stats_name:
        cfg = dataclasses.replace(cfg, stats_name="statsMS" if cfg.mode == "oscd" else "stats")
    if cfg.mode == "whu":
        return run_whu(cfg, device)
    if cfg.mode == "oscd":
        return run_oscd(cfg, device)
    return run_scene(cfg, device)


def run_scene(cfg: InferConfig, device: torch.device) -> Dict:
    """One raster pair (JAX ``run``, :114-310)."""
    from ..data.datasets import ScenePairDataset
    from ..data.normalize import Normalize
    from ..data.raster import create_raster
    from ..data.stats import dataset_meanstd
    from ..eval.changemap import write_changemap_gdal
    from ..eval.evaluator import Evaluator
    from ..data.device_cache import DeviceSceneCache
    from ..eval.inference import stitched_inference, transfer_type
    from ..eval.roc import RocCurve

    outdir = cfg.outdir or cfg.dir
    os.makedirs(outdir, exist_ok=True)
    img_x = os.path.join(cfg.dir, cfg.image_x_name)
    img_y = os.path.join(cfg.dir, cfg.image_y_name)
    ref_path = os.path.join(cfg.dir, cfg.ref_name) if cfg.ref_name else None
    stem1, ext1 = os.path.splitext(cfg.image_x_name)
    stem2, _ = os.path.splitext(cfg.image_y_name)
    cmap_name = "{}{}".format(cfg.cmap_name, cfg.ext)
    out_path = os.path.join(outdir, cmap_name + ext1)
    out_color_path = os.path.join(outdir, "{}_acc_color{}".format(cmap_name, ext1))

    # normalizer from the shared stats caches
    stats_ds = ScenePairDataset(img_x, img_y, patch_size=cfg.patch_size,
                                overlap_padding=(0, 0))
    sp1 = os.path.join(cfg.dir, "{}_{}.txt".format(stem1, cfg.stats_name))
    sp2 = os.path.join(cfg.dir, "{}_{}.txt".format(stem2, cfg.stats_name))
    scaler = Normalize(*dataset_meanstd(sp1, sp2, stats_ds))
    dataset = ScenePairDataset(img_x, img_y, ref_path=ref_path, out_path=out_path,
                               enhance=scaler, patch_size=cfg.patch_size,
                               overlap_padding=cfg.overlap_padding)
    net = _segmentor(cfg, device, dataset.size()[2])

    acc = Evaluator(num_class=len(cfg.gt_map)) if ref_path else None
    roc = RocCurve() if ref_path else None
    color = {}  # the color raster, created at its first write

    def write_color(codes: np.ndarray, x0: int, y0: int) -> None:
        if "raster" not in color:
            xs, ys, _ = dataset.size()
            color["raster"] = create_raster(out_color_path, xs, ys, 1, np.int32,
                                            like=dataset.raster_x)
        color["raster"].write_block(codes.astype(np.int32), x0, y0, band=0)

    def add(density: np.ndarray, ref: np.ndarray, x0: int, y0: int) -> None:
        """Color codes and metrics of a (h, w) density window at (x0, y0)."""
        cmask = (density > cfg.prob_thresh).astype(np.int16)
        if cfg.write_color:
            write_color(write_changemap_gdal(cmask[None], ref[None], write_color=True,
                                             ref_map=cfg.gt_map, dt_map=cfg.pre_map)[0],
                        x0, y0)
        acc.add_batch_map(ref, cmask, list(cfg.gt_map), list(cfg.pre_map))
        roc.add_batch(density, ref == cfg.gt_map[1])

    done = 0

    def on_tile(item: int, d: np.ndarray) -> None:
        # the tile's interior, at its core in the scene (JAX :254-300)
        nonlocal done
        if acc is not None:
            x0, y0, w, h = dataset.grid.slices(item)[0]
            add(d, dataset.raster_ref.read_block(x0, y0, w, h)[..., 0].astype(np.int16),
                x0, y0)
        done += 1
        _progress(cfg, done, len(dataset))

    # as the JAX tool (:182-230): a scene past the resident budget streams
    # through BatchLoader (the library function would take the window)
    feed = cfg.device_feed
    if feed == "auto" and not DeviceSceneCache.supports(dataset):
        feed = "stream"
    res = stitched_inference(dataset, net, cfg.batch_size, device,
                             device_feed=feed, density_dtype=cfg.density_dtype,
                             transfer_dtype=transfer_type(cfg.transfer_dtype),
                             prefetch_depth=cfg.prefetch_depth, on_tile=on_tile,
                             use_native=False)
    if cfg.progress and not res["fused"]:
        print("\r", end="", flush=True)
    if res["fused"] and acc is not None:
        # interiors tile the scene disjointly: the full arrays give the same
        # color raster and metrics as the per-tile path
        add(res["density"], dataset.raster_ref.read_block()[..., 0].astype(np.int16), 0, 0)
    if "raster" in color:
        color["raster"].close()
    out = {"density_path": out_path, "color_path": out_color_path if "raster" in color else None,
           "pixels": res["pixels"], "seconds": res["seconds"], "px_per_s": res["px_per_s"],
           "fused": res["fused"], "feed": res["feed"], "device": _device_name(device)}
    return _summarize(out, acc, roc)


def _summarize(out: Dict, acc, roc) -> Dict:
    if acc is not None:
        miou, ciou = acc.Mean_Intersection_over_Union()
        out.update(oa=acc.Pixel_Accuracy(), kappa=acc.Pixel_Kappa(),
                   precision=acc.Pixel_Precision_Rate(),
                   recall=acc.Pixel_Recall_Rate(), f1=acc.Pixel_F1_score(),
                   miou=miou, ciou=ciou, auc=roc.auc())
        out["evaluator"] = acc
    print(_json_line(out))
    return out


@torch.no_grad()
def run_whu(cfg: InferConfig, device: torch.device) -> Dict:
    """A WSSS checkpoint over a WHU slice set (JAX ``run_whu``, :325-440):
    per-slice eval images via ``write_changemap`` (FN blue, FP red, TP white,
    or grey) and, with ``write_grey``, density images (cmap * 255), named as
    the slices. ``bn_mode='train'`` replicates the reference's train-mode-BN
    inference ("train mode gets better performance", Demo_WSSS.py:389-391):
    S's BN statistics come from each batch's real slices only (the
    wrap-padded tail's duplicates would skew them; JAX :395-403), through
    the ``channel_sums`` kernel on the card, and its running buffers move
    from batch to batch; ``eval`` uses the checkpoint's running
    statistics."""
    from ..data.datasets import WHUDataset
    from ..data.normalize import Normalize
    from ..data.pipeline import BatchLoader, prefetch
    from ..data.raster import write_image
    from ..data.stats import dataset_meanstd
    from ..eval.changemap import write_changemap
    from ..eval.evaluator import Evaluator
    from ..eval.inference import nhwc_infer, run_overlapped, upload
    from ..utils.download import Download

    if not (cfg.img_dir_x and cfg.img_dir_y and cfg.ref_dir and cfg.label_dir):
        raise SystemExit("whu mode needs --img-dir-x/--img-dir-y/--ref-dir/--label-dir")
    out_dir = cfg.outdir or os.path.join(cfg.label_dir, "Detection_serve{}".format(cfg.ext))
    os.makedirs(out_dir, exist_ok=True)
    out_density_dir = out_dir + "_Density"
    if cfg.write_grey:
        os.makedirs(out_density_dir, exist_ok=True)

    # the stats caches of the WSSS demo (Demo_WSSS.py:70-78)
    stats_ds = WHUDataset(cfg.img_dir_x, cfg.img_dir_y, cfg.ref_dir, cfg.label_dir, "-1")
    sp1 = os.path.join(cfg.img_dir_x, "{}_meanstd.txt".format(cfg.stats_name))
    sp2 = os.path.join(cfg.img_dir_y, "{}_meanstd.txt".format(cfg.stats_name))
    scaler = Normalize(*dataset_meanstd(sp1, sp2, stats_ds))
    ds = WHUDataset(cfg.img_dir_x, cfg.img_dir_y, cfg.ref_dir, cfg.label_dir,
                    label_selected=cfg.label_selected, scale=scaler)
    h, w, nband = ds[0][0].shape
    net = _segmentor(cfg, device, nband)
    if cfg.bn_mode == "train":
        net.train()
    infer = nhwc_infer(net)

    loader = BatchLoader(ds, cfg.batch_size, fields=("x", "y", "ref", "item", "label"),
                         shuffle=False)
    acc = Evaluator(num_class=2)
    pixels = 0
    done = 0
    t0 = time.perf_counter()

    def compute(batch):
        nonlocal pixels
        n_real = int(batch["weight"].sum())
        pixels += h * w * n_real
        bx, by = batch["x"], batch["y"]
        if cfg.bn_mode == "train":  # the real slices only, as the reference's short tail
            bx, by = bx[:n_real], by[:n_real]
        return Download(infer(upload(np.ascontiguousarray(bx), device),
                              upload(np.ascontiguousarray(by), device)))

    def process(dl: Download, batch):
        nonlocal done
        cmap = dl.result().numpy()
        cmask = (cmap > cfg.prob_thresh).astype(np.int16)
        for ns in range(len(cmap)):
            if batch["weight"][ns] == 0:
                continue
            item = int(batch["item"][ns])
            change_mask = cmask[ns, :, :, 0]
            ref_mask = batch["ref"][ns][:, :, 0]
            acc.add_batch_map(ref_mask.astype(np.int16), change_mask)
            name = ds.get_file_name(item)
            if cfg.write_grey:
                write_image(os.path.join(out_density_dir, name), np.uint8(cmap[ns, :, :, 0] * 255))
            change_write = write_changemap(change_mask, ref_mask, cfg.write_color)
            if change_write.ndim == 3:
                change_write = change_write.transpose((1, 2, 0))
            write_image(os.path.join(out_dir, name), np.uint8(change_write))
            done += 1
        _progress(cfg, done, len(ds))

    run_overlapped(prefetch(iter(loader), cfg.prefetch_depth), compute, process)
    seconds = time.perf_counter() - t0
    if cfg.progress:
        print("\r", end="", flush=True)
    miou, ciou = acc.Mean_Intersection_over_Union()
    out = {"out_dir": out_dir, "density_dir": out_density_dir if cfg.write_grey else None,
           "pixels": pixels, "seconds": seconds, "px_per_s": pixels / max(seconds, 1e-9),
           "slices": len(ds), "slices_per_s": len(ds) / max(seconds, 1e-9),
           "oa": acc.Pixel_Accuracy(), "kappa": acc.Pixel_Kappa(),
           "precision": acc.Pixel_Precision_Rate(), "recall": acc.Pixel_Recall_Rate(),
           "f1": acc.Pixel_F1_score(), "miou": miou, "ciou": ciou,
           "device": _device_name(device)}
    print(_json_line(out))
    out["evaluator"] = acc
    return out


@torch.no_grad()
def run_oscd(cfg: InferConfig, device: torch.device) -> Dict:
    """An RSSS checkpoint over an OSCD scene list (JAX ``run_oscd``,
    :443-637): per-scene stitched density and color rasters (binary {0, 1}
    with ``write_color=False``, as the RSSS demo writes) in each scene's
    ``ImagePair/``, metrics over the tile interiors (EffRange), per-scene
    normalizers from the RSSS demo's ``*_statsMS.txt`` caches.

    Fused (``device_feed='auto'`` and every scene resident-capable): one
    ``DeviceSceneCache`` per scene and two scenes in flight, scene i+1
    started before scene i's download is resolved, written and scored
    (:519-534). Otherwise the scene list streams through
    ``NativeOSCDBatchLoader`` (``feed`` native), or ``BatchLoader`` without
    the native library (``feed`` host)."""
    from ..data.datasets import OSCDDataset
    from ..data.device_cache import DeviceSceneCache
    from ..data.pipeline import BatchLoader, NativeOSCDBatchLoader, prefetch
    from ..demos.demo_rsss import _scene_scalers
    from ..eval.changemap import write_changemap_gdal
    from ..eval.evaluator import Evaluator
    from ..eval.inference import (cropped_infer, nhwc_infer, quantized_infer,
                                  run_overlapped, transfer_type, upload)
    from ..eval.roc import RocCurve
    from ..utils.download import Download

    scalers = _scene_scalers(cfg.dir, cfg.txt_name, cfg.patch_size, cfg.stats_name)
    dataset = OSCDDataset(cfg.dir, cfg.txt_name, scaler=scalers, patch_size=cfg.patch_size,
                          overlap_padding=cfg.overlap_padding)
    net = _segmentor(cfg, device, dataset.dslist[0].ds.size()[2])
    density_name = "{}{}".format(cfg.out_name_density, cfg.ext)
    color_name = "{}{}".format(cfg.out_name_binary, cfg.ext)
    acc = Evaluator(num_class=len(cfg.gt_map))
    roc = RocCurve()
    pixels = 0
    fused = cfg.device_feed == "auto" and all(
        DeviceSceneCache.supports(s.ds) for s in dataset.dslist)
    t0 = time.perf_counter()
    feed = "resident"

    if fused:
        def resolve(s_idx, base, handle):
            nonlocal pixels
            density = DeviceSceneCache.stitched_density_finish(handle, cfg.density_dtype)
            dataset.write_full_scene(s_idx, density, density_name)
            cmask = (density > cfg.prob_thresh).astype(np.int16)
            ref = (base.raster_ref.read_block()[..., 0].astype(np.int16)
                   if base.raster_ref is not None else np.zeros_like(cmask))
            codes = write_changemap_gdal(cmask[None], ref[None], write_color=cfg.write_color,
                                         ref_map=cfg.gt_map, dt_map=cfg.pre_map)
            dataset.write_full_scene(s_idx, codes[0].astype(np.float32), color_name)
            acc.add_batch_map(ref, cmask, list(cfg.gt_map), list(cfg.pre_map))
            roc.add_batch(density, ref == cfg.gt_map[1])
            pixels += int(density.size)

        prev = None
        for s_idx, scene in enumerate(dataset.dslist):
            base = scene.ds
            handle = DeviceSceneCache(base, base.enhance, device).stitched_density_start(
                net, cfg.batch_size, cfg.density_dtype)
            if prev is not None:
                resolve(*prev)
            prev = (s_idx, base, handle)
        if prev is not None:
            resolve(*prev)
    else:
        infer, dequant = quantized_infer(
            cropped_infer(nhwc_infer(net), cfg.overlap_padding, cfg.patch_size),
            cfg.density_dtype)
        tdt = transfer_type(cfg.transfer_dtype)
        pady, padx = cfg.overlap_padding[1], cfg.overlap_padding[0]
        interior = dataset.interior_sizes()
        # the native per-scene assembly (its tail wrap-padded, weight 0),
        # else BatchLoader (JAX :556-565)
        if NativeOSCDBatchLoader.supports(dataset):
            feed = "native"
            loader = NativeOSCDBatchLoader(dataset, cfg.batch_size, shuffle=False)
        else:
            feed = "host"
            loader = BatchLoader(dataset, cfg.batch_size,
                                 fields=("x", "y", "item", "ref", "region"), shuffle=False)
        done = 0

        def compute(batch):
            nonlocal pixels
            pixels += int(sum(np.prod(interior[int(i)]) for i, w in
                              zip(batch["item"], batch["weight"]) if w > 0))
            return Download(infer(upload(batch["x"], device, tdt), upload(batch["y"], device, tdt)))

        def process(dl: Download, batch):
            nonlocal done
            cmap = dequant(dl.result())
            cmask = (cmap > cfg.prob_thresh).astype(np.int16)
            for ns in range(len(cmap)):
                if batch["weight"][ns] == 0:
                    continue
                item = int(batch["item"][ns])
                dataset.write(cmap[ns], item, density_name)
                # the host reference cropped to the device crop's origin
                ref_hw = batch["ref"][ns][..., 0]
                if pady or padx:
                    ref_hw = ref_hw[pady:-pady or None, padx:-padx or None]
                cmask_hw = cmask[ns, :, :, 0]
                codes = write_changemap_gdal(cmask_hw[None], ref_hw[None],
                                             write_color=cfg.write_color,
                                             ref_map=cfg.gt_map, dt_map=cfg.pre_map)
                dataset.write(np.moveaxis(codes, 0, -1), item, color_name)
                ch, cw = interior[item]
                acc.add_batch_map(ref_hw[:ch, :cw].astype(np.int16), cmask_hw[:ch, :cw],
                                  list(cfg.gt_map), list(cfg.pre_map))
                roc.add_batch(cmap[ns, :ch, :cw, 0], ref_hw[:ch, :cw] == cfg.gt_map[1])
                done += 1
            _progress(cfg, done, len(dataset))

        run_overlapped(prefetch(iter(loader), cfg.prefetch_depth), compute, process)
        if cfg.progress:
            print("\r", end="", flush=True)
    seconds = time.perf_counter() - t0
    dataset.close_outputs()
    miou, ciou = acc.Mean_Intersection_over_Union()
    out = {"scenes": dataset.namelist, "density_name": density_name, "color_name": color_name,
           "pixels": pixels, "seconds": seconds, "px_per_s": pixels / max(seconds, 1e-9),
           "fused": fused, "feed": feed, "oa": acc.Pixel_Accuracy(), "kappa": acc.Pixel_Kappa(),
           "precision": acc.Pixel_Precision_Rate(), "recall": acc.Pixel_Recall_Rate(),
           "f1": acc.Pixel_F1_score(), "miou": miou, "ciou": ciou, "auc": roc.auc(),
           "device": _device_name(device)}
    print(_json_line(out))
    out["evaluator"] = acc
    return out


def main(argv=None):
    from ..config import parse_cli

    # the production serving default of the JAX tool (:640-652): 32-wide
    # fused chunks; FCDGAN_SERVE_BS=0 restores batch-exact chunking
    os.environ.setdefault("FCDGAN_SERVE_BS", "32")
    return run(parse_cli(InferConfig, argv))


if __name__ == "__main__":
    main()
