"""Regional supervised change detection driver (reference: Demo_RSSS.py).

Port of the JAX package's ``demos/demo_rsss.py``: per-scene normalizers
over the OSCD layout (cached ``statsMS`` txts) -> the feed of the train and
test scene lists -> G pretrain with the REGION raster as the mask (skipped
when ``GModel.pkl`` is reused) -> adversarial S vs D epochs with
region-synthesized unchanged pairs and the two region losses, each epoch
followed by the test evaluation (train-mode BN by default, as the
reference) -> the final eval-mode inference, tile by tile, into a density
and a color raster per test scene (``{scene}/ImagePair/density{ext}`` and
``color{ext}``, the color raster coded {0 TN, 1 FN, 2 FP, 3 TP}) ->
``Para.txt`` and ``SModel.pkl`` / ``DModel.pkl`` (``{img_dir}/model{ext}``)
and ``GModel.pkl`` (``out_g_model_dir``), reference state_dicts. The
inference runs synchronously.

The feed is the JAX driver's choice (demo_rsss.py:95-135), named in the
result's ``feed``: ``resident`` (the raw tile stacks on the device,
``--tile-cache auto|on`` within ``FCDGAN_TILE_CACHE_MAX_MB``), else
``NativeOSCDBatchLoader`` (``native``; its tails are wrap-padded with
weight-0 duplicates, which train-mode BN sees in the G pretrain and the
adversarial steps, as in the JAX package; the test evaluation trims them),
else ``BatchLoader`` (``host``).

Run (on the GPU unless ``--device cpu``):

    python -m fcdgan_tpu_torch.demos.demo_rsss --img-dir /OSCD-10m-Dataset \\
        --out-g-model-dir /OSCD-10m-Dataset/GModel

``run`` returns the JAX driver's result dict (demo_rsss.py:397-411), with
the trained modules under ``sstate`` / ``gstate`` / ``dstate`` and, in
addition, each epoch's averaged losses with the accuracy of its train
batches, and each test evaluation's accuracy (``epoch_metrics``), and the wall
seconds of every epoch of each phase, of each test evaluation and of the
inference (``epoch_seconds``), each ending when its metrics reached the host.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..config import RSSSConfig, parse_cli, unported_rsss
from ..data.datasets import OSCDDataset, ScenePairDataset
from ..data.device_cache import DeviceOSCDCache
from ..data.normalize import Normalize
from ..data.pipeline import BatchLoader, NativeOSCDBatchLoader, device_put_batch, prefetch
from ..data.stats import dataset_meanstd
from ..eval.changemap import write_changemap_gdal
from ..eval.evaluator import Evaluator
from ..io.checkpoint import model_g_reuse, save_net
from ..io.records import ScalarWriter, segmentation_summary, write_para_txt
from ..models.discriminator import Discriminator
from ..models.generator import Generator
from ..models.segmentor import Segmentor
from ..models.vgg import VGG16Weights, load_vgg16_params, select_feature_layers
from ..train import schedules
from ..train.loops import EpochAverages, Progress, accuracy_line
from ..train.optim import adam, rmsprop
from ..train.steps import PerceptionConfig, RSSSSteps
from ..utils.device import resolve_device
from .demo_usss import _DTYPES, _log_accuracy

G_KEYS = ("g_loss", "generator_loss", "perception_loss", "ssim_loss")
ADV_KEYS = ("g_loss", "d_loss", "s_loss", "s_d_loss", "l1_loss", "r_loss",
            "generator_loss", "perception_loss", "ssim_loss")


def _check_supported(cfg: RSSSConfig) -> None:
    missing = unported_rsss(cfg)
    if missing:
        raise NotImplementedError(
            "not ported to fcdgan_tpu_torch yet: {}; see ROADMAP.md (queue A, "
            "'The rest of training')".format("; ".join(missing)))
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute-dtype must be one of {sorted(_DTYPES)}")
    if cfg.test_eval_bn not in ("train", "eval"):
        raise ValueError("--test-eval-bn must be 'train' or 'eval'")
    if cfg.tile_cache not in ("auto", "on", "off"):
        raise ValueError(f"--tile-cache must be auto, on or off, not {cfg.tile_cache!r}")


FIELDS = ("x", "y", "item", "ref", "region")


def tile_feed(cfg: RSSSConfig, dataset, test_dataset, device):
    """(feed name, train cache, test cache) of the JAX driver's choice
    (demo_rsss.py:95-135): the resident tile stacks of both lists, else
    ``NativeOSCDBatchLoader``, else ``BatchLoader`` (no caches).
    ``--tile-cache on`` raises when the stacks cannot be resident."""
    if (cfg.tile_cache != "off" and DeviceOSCDCache.supports(dataset)
            and DeviceOSCDCache.supports(test_dataset)):
        return ("resident", DeviceOSCDCache(dataset, device),
                DeviceOSCDCache(test_dataset, device))
    if cfg.tile_cache == "on":
        raise RuntimeError("--tile-cache on: needs the tiles within FCDGAN_TILE_CACHE_MAX_MB")
    if all(NativeOSCDBatchLoader.supports(ds) for ds in (dataset, test_dataset)):
        return "native", None, None
    return "host", None, None


def _loader(feed: str, ds, cache, batch_size: int, shuffle: bool, seed: int):
    """The epoch batches of ``ds`` on its feed."""
    if cache is not None:
        return cache.loader(batch_size, shuffle=shuffle, seed=seed)
    if feed == "native":
        return NativeOSCDBatchLoader(ds, batch_size, shuffle=shuffle, seed=seed)
    return BatchLoader(ds, batch_size, fields=FIELDS, shuffle=shuffle, seed=seed, tail="short")


def _accuracy(ev: Evaluator) -> Dict[str, float]:
    """Overall accuracy, kappa and F1 of an evaluator (F1 is NaN while no
    pixel is detected as changed)."""
    return {"oa": float(ev.Pixel_Accuracy()), "kappa": float(ev.Pixel_Kappa()),
            "f1": float(ev.Pixel_F1_score())}


def _scene_scalers(img_dir: str, txt_name: str, patch_size, stats_name: str) -> List:
    """Per-scene normalizers with cached ``{image}_{stats_name}.txt`` files
    beside the images (Demo_RSSS.py:75-97, demo_rsss.py:42-58)."""
    scalers = []
    for img_x, img_y, _, _ in OSCDDataset(img_dir, txt_name).pathlist:
        cur_dir, name_x = os.path.split(img_x)
        name_y = os.path.split(img_y)[1]
        stats_ds = ScenePairDataset(img_x, img_y, patch_size=patch_size,
                                    overlap_padding=(0, 0))
        sp1 = os.path.join(cur_dir, "{}_{}.txt".format(os.path.splitext(name_x)[0], stats_name))
        sp2 = os.path.join(cur_dir, "{}_{}.txt".format(os.path.splitext(name_y)[0], stats_name))
        scalers.append(Normalize(*dataset_meanstd(sp1, sp2, stats_ds)))
    return scalers


def run(cfg: RSSSConfig) -> Dict:
    _check_supported(cfg)
    device = resolve_device(cfg.device)
    dtype = _DTYPES[cfg.compute_dtype]
    torch.manual_seed(cfg.seed)
    out_dir = os.path.join(cfg.img_dir, "model{}".format(cfg.ext))
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(cfg.out_g_model_dir, exist_ok=True)

    # -- datasets with per-scene normalizers and their feed (Demo_RSSS.py:75-134)
    def scene_list(txt_name):
        scalers = _scene_scalers(cfg.img_dir, txt_name, cfg.patch_size, cfg.stats_name)
        return OSCDDataset(cfg.img_dir, txt_name, scaler=scalers, patch_size=cfg.patch_size,
                           overlap_padding=cfg.overlap_padding)

    dataset, test_dataset = scene_list(cfg.txt_name), scene_list(cfg.test_txt_name)
    total, total_test = len(dataset), len(test_dataset)
    feed, train_cache, test_cache = tile_feed(cfg, dataset, test_dataset, device)
    init_loader = _loader(feed, dataset, train_cache, cfg.init_batch_size, True, cfg.seed)
    train_loader = _loader(feed, dataset, train_cache, cfg.batch_size, True, cfg.seed + 1)
    test_loader = _loader(feed, test_dataset, test_cache, cfg.batch_size, False, cfg.seed)

    def put(batch, cache):
        if cache is not None:
            return cache.complete(batch)
        return device_put_batch({k: batch[k] for k in FIELDS + ("weight",)}, device)

    # -- models / optimizers (Demo_RSSS.py:137-158) --------------------------
    nband = dataset.dslist[0].ds.raster_x.nband
    net_g = Generator(nband, compute_dtype=dtype)
    net_s = Segmentor(nband, compute_dtype=dtype)
    net_d = Discriminator(nband, compute_dtype=dtype)
    init_epochs_g = model_g_reuse(cfg.out_g_model_dir, net_g, cfg.init_num_epochs_g,
                                  cfg.model_g_reuse)
    for net in (net_g, net_s, net_d):
        net.to(device)
    vgg = VGG16Weights(load_vgg16_params(cfg.vgg_npz, require=cfg.require_vgg), device)
    steps = RSSSSteps(
        net_g, net_s, net_d, adam(net_g.parameters()), rmsprop(net_s.parameters()),
        rmsprop(net_d.parameters()), vgg,
        PerceptionConfig(select_feature_layers(cfg.perception_layer),
                         cfg.perception_per_band,
                         dtype=dtype if dtype == torch.bfloat16 else None),
        cfg.perception_weight, cfg.ssim_weight, cfg.g_weight, cfg.l1_weight,
        cfg.d_weight, cfg.r_weight, dataset.interior_sizes(), cfg.overlap_padding,
        cfg.gt_map, cfg.pre_map, cfg.prob_thresh, cfg.discriminator_continuous,
        cfg.msssim_weights, test_interior_sizes=test_dataset.interior_sizes(),
        ssim_metric=cfg.ssim_metric)
    writer = ScalarWriter(comment="RSSS_OSCD{}".format(cfg.ext), enabled=cfg.log_tensorboard)
    seconds = {"g": [], "adv": [], "test": [], "infer": 0.0}
    metrics = {"g": [], "adv": [], "test": []}

    # -- phase 1: G pretrain with region masks (Demo_RSSS.py:173-238) --------
    print("Start Generator Training")
    for i in range(init_epochs_g):
        t0 = time.perf_counter()
        lr = schedules.G_PRETRAIN(i / cfg.lr_epoch_scale) * cfg.lr_scale
        av = EpochAverages(total)
        prog = Progress(total, lambda: init_epochs_g - 1 - i, cfg.progress)
        for batch in prefetch(iter(init_loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put(batch, train_cache)
            bw = float(batch["weight"].sum())
            av.update(steps.g_pretrain(db["x"], db["y"], db["region"], db["weight"], lr), bw)
            prog.end_batch(int(bw))
        prog.finish()
        print("Epochs: {}/{}, g_loss: {:.4f}, generator_loss: {:.4f}, "
              "perception_loss:{:.4f}, ssim_loss:{:.4f}".format(
                  i + 1, init_epochs_g, av["g_loss"], av["generator_loss"],
                  av["perception_loss"], av["ssim_loss"]))
        for k in G_KEYS:
            writer.add_scalar(k, av[k], i)
        seconds["g"].append(time.perf_counter() - t0)
        metrics["g"].append(av.as_dict())

    # -- phase 2: adversarial + per-epoch test eval (Demo_RSSS.py:244-447) ---
    print("Start Adversarial Training")
    test_acc = None
    for i in range(cfg.num_epochs):
        t0 = time.perf_counter()
        lr_s = schedules.S_ADV_RSSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        lr_d = schedules.D_ADV_RSSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        av = EpochAverages(total)
        prog = Progress(total, lambda: cfg.num_epochs - 1 - i, cfg.progress)
        for batch in prefetch(iter(train_loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put(batch, train_cache)
            bw = float(batch["weight"].sum())
            av.update(steps.adversarial(db["x"], db["y"], db["ref"], db["region"], db["item"],
                                        db["weight"], lr_s, lr_d), bw)
            prog.end_batch(int(bw))
        prog.finish()
        ev = av.evaluator(len(cfg.gt_map))
        print("Epochs: {}/{}, d_loss: {:.4f}, g_loss: {:.4f}, s_loss: {:.4f}, "
              "l1_loss:{:.4f}, s_d_loss: {:.4f}, r_loss: {:.4f}".format(
                  i + 1, cfg.num_epochs, av["d_loss"], av["g_loss"], av["s_loss"],
                  av["l1_loss"], av["s_d_loss"], av["r_loss"]))
        print(accuracy_line(i, cfg.num_epochs, ev))
        seconds["adv"].append(time.perf_counter() - t0)
        metrics["adv"].append({**av.as_dict(), **_accuracy(ev)})

        # the test evaluation (Demo_RSSS.py:399-447); a wrap-padded tail is
        # trimmed to its real tiles, so train-mode BN sees no duplicates
        t0 = time.perf_counter()
        test_av = EpochAverages(1)
        evaluate = (steps.eval_confusion_train if cfg.test_eval_bn == "train"
                    else steps.eval_confusion)
        for batch in prefetch(iter(test_loader), cfg.prefetch_depth):
            n_real = int(np.asarray(batch["weight"]).sum())
            if cfg.test_eval_bn == "train" and n_real < len(batch["weight"]):
                batch = {k: v[:n_real] for k, v in batch.items()}
            db = put(batch, test_cache)
            cm, _ = evaluate(db["x"], db["y"], db["ref"], db["item"], db["weight"])
            test_av.update({"confusion": cm}, 0.0)
        test_acc = test_av.evaluator(len(cfg.gt_map))
        miou, ciou = test_acc.Mean_Intersection_over_Union()
        print("Test Dataset: Overall Accuracy: {:.4f}, Kappa: {:.4f}, "
              "Precision Rate: {:.4f}, Recall Rate: {:.4f}, F1:{:.4f}, "
              "mIOU:{:.4f}, cIoU:{:.4f}".format(
                  test_acc.Pixel_Accuracy(), test_acc.Pixel_Kappa(),
                  test_acc.Pixel_Precision_Rate(), test_acc.Pixel_Recall_Rate(),
                  test_acc.Pixel_F1_score(), miou, ciou))
        step = i + init_epochs_g
        for k in ADV_KEYS:
            writer.add_scalar(k, av[k], step)
        _log_accuracy(writer, ev, step)
        _log_accuracy(writer, test_acc, step, prefix="Test ")
        seconds["test"].append(time.perf_counter() - t0)
        metrics["test"].append(_accuracy(test_acc))

    # -- final inference: density + color rasters per scene (:449-504) -------
    print("Saving Change Map and Model")
    print("Segmentation of Change")
    t0 = time.perf_counter()
    acc = Evaluator(num_class=len(cfg.gt_map))
    density_name = "{}{}".format(cfg.out_name_density, cfg.ext)
    color_name = "{}{}".format(cfg.out_name_binary, cfg.ext)
    for batch in prefetch(iter(test_loader), cfg.prefetch_depth):
        db = put(batch, test_cache)
        cmap = steps.infer(db["x"], db["y"]).cpu().numpy()
        ref = db["ref"].cpu().numpy()
        cmask = (cmap > cfg.prob_thresh).astype(np.int16)
        for ns, item in enumerate(batch["item"]):
            if batch["weight"][ns] == 0:
                continue
            item = int(item)
            test_dataset.write(cmap[ns], item, density_name)
            ref_chw = np.moveaxis(ref[ns], -1, 0)
            cmask_chw = np.moveaxis(cmask[ns], -1, 0)
            codes = write_changemap_gdal(cmask_chw, ref_chw, write_color=cfg.write_color,
                                         ref_map=cfg.gt_map, dt_map=cfg.pre_map)
            test_dataset.write(np.moveaxis(codes, 0, -1), item, color_name)
            y0, y1, x0, x1 = test_dataset.eff_range(item)
            acc.add_batch_map(ref_chw[0, y0:y1, x0:x1].astype(np.int16),
                              cmask_chw[0, y0:y1, x0:x1], cfg.gt_map, cfg.pre_map)
    test_dataset.close_outputs()
    seconds["infer"] = time.perf_counter() - t0
    print(segmentation_summary(acc))
    print("\r" + "End of Saving", flush=True)

    # -- save + Para txt (Demo_RSSS.py:506-538) -------------------------------
    smodel_path = os.path.join(out_dir, "SModel.pkl")
    gmodel_path = os.path.join(cfg.out_g_model_dir, "GModel.pkl")
    dmodel_path = os.path.join(out_dir, "DModel.pkl")
    if cfg.save_checkpoints:
        save_net(smodel_path, net_s)
        save_net(gmodel_path, net_g)
        save_net(dmodel_path, net_d)
    writer.close()
    para_path = write_para_txt(os.path.join(out_dir, "Para.txt"), {
        "perception_weight": cfg.perception_weight,
        "ssim_weight": cfg.ssim_weight,
        "perception_perBand": cfg.perception_per_band,
        "perception_layer": cfg.perception_layer,
        "l1_weight": cfg.l1_weight,
        "g_weight": cfg.g_weight,
        "d_weight": cfg.d_weight,
        "r_weight": cfg.r_weight,
        "discriminator_continuous": cfg.discriminator_continuous,
        "prob_thresh": cfg.prob_thresh,
    }, acc=acc, tips=cfg.tips)
    return {
        "evaluator": acc,
        "test_evaluator": test_acc,
        "out_dir": out_dir,
        "density_name": density_name,
        "color_name": color_name,
        "para_path": para_path,
        "smodel_path": smodel_path if cfg.save_checkpoints else None,
        "gmodel_path": gmodel_path if cfg.save_checkpoints else None,
        "dmodel_path": dmodel_path if cfg.save_checkpoints else None,
        "sstate": net_s,
        "gstate": net_g,
        "dstate": net_d,
        "epoch_metrics": metrics,
        "epoch_seconds": seconds,
        "g_pretrain_epochs": init_epochs_g,
        "tiles": total,
        "test_tiles": total_test,
        "feed": feed,
    }


def main(argv=None) -> Dict:
    return run(parse_cli(RSSSConfig, argv))


if __name__ == "__main__":
    main()
