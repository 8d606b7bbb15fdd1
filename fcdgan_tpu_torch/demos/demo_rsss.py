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
inference runs synchronously; ``--density-dtype uint8|bfloat16`` quantizes
its downloads.

The feed is the JAX driver's choice (demo_rsss.py:95-135), named in the
result's ``feed`` (the train list) and ``test_feed``: ``resident`` (the raw
tile stacks of both lists on the device, ``--tile-cache auto|on`` within
``FCDGAN_TILE_CACHE_MAX_MB``), else, each list on its own,
``NativeOSCDBatchLoader`` (``native``; its tails are wrap-padded with
weight-0 duplicates, which train-mode BN sees in the G pretrain and the
adversarial steps, as in the JAX package; the test evaluation trims them),
else ``BatchLoader`` (``host``). ``--random-eraser`` erases the train
scenes' tiles on ``BatchLoader`` only: the caches and the native loader
refuse a list with a sync transform.

The training options are the JAX driver's (see ``demo_usss``):
``--siamese-stats split`` (here for S and D), ``--remat``, ``--tail pad``,
``--checkpoint-every`` / ``--resume`` (``{img_dir}/model{ext}/resume.ckpt``,
saved after each epoch's test evaluation), ``--profile-dir`` and
``--debug-nans``.

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

from ..config import RSSSConfig, batch_tail, check_training_options, parse_cli
from ..data.datasets import OSCDDataset, ScenePairDataset
from ..data.erasers import build_eraser
from ..data.device_cache import DeviceOSCDCache
from ..data.normalize import Normalize
from ..data.pipeline import BatchLoader, NativeOSCDBatchLoader, device_put_batch, prefetch
from ..data.stats import dataset_meanstd
from ..eval.changemap import write_changemap_gdal
from ..eval.evaluator import Evaluator
from ..io.checkpoint import TrainCheckpointer, model_g_reuse, save_net
from ..io.records import ScalarWriter, segmentation_summary, write_para_txt
from ..models.discriminator import Discriminator
from ..models.generator import Generator
from ..models.segmentor import Segmentor
from ..models.vgg import VGG16Weights, load_vgg16_params, select_feature_layers
from ..parallel import mesh
from ..parallel.multihost import put_multihost
from ..train import schedules
from ..train.loops import EpochAverages, Progress, accuracy_line, nan_checked
from ..train.optim import adam, rmsprop
from ..train.steps import PerceptionConfig, RSSSSteps
from ..utils.device import resolve_device
from ..utils.download import dequantize, quantize
from ..utils.timing import maybe_profile
from .demo_usss import _DTYPES, _log_accuracy

G_KEYS = ("g_loss", "generator_loss", "perception_loss", "ssim_loss")
ADV_KEYS = ("g_loss", "d_loss", "s_loss", "s_d_loss", "l1_loss", "r_loss",
            "generator_loss", "perception_loss", "ssim_loss")


def _check_supported(cfg: RSSSConfig) -> None:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute-dtype must be one of {sorted(_DTYPES)}")
    check_training_options(cfg)
    if cfg.test_eval_bn not in ("train", "eval"):
        raise ValueError("--test-eval-bn must be 'train' or 'eval'")
    if cfg.tile_cache not in ("auto", "on", "off"):
        raise ValueError(f"--tile-cache must be auto, on or off, not {cfg.tile_cache!r}")


FIELDS = ("x", "y", "item", "ref", "region")


def tile_feed(cfg: RSSSConfig, dataset, test_dataset, device):
    """(train feed, test feed, train cache, test cache) of the JAX driver's
    choice (demo_rsss.py:95-135): the resident tile stacks of both lists,
    else for each list ``NativeOSCDBatchLoader``, else ``BatchLoader`` (no
    caches). ``--tile-cache on`` raises when the stacks cannot be resident;
    multi-host takes no stacks (demo_rsss.py:102)."""
    if (cfg.tile_cache != "off" and not mesh.multihost() and DeviceOSCDCache.supports(dataset)
            and DeviceOSCDCache.supports(test_dataset)):
        return ("resident", "resident", DeviceOSCDCache(dataset, device),
                DeviceOSCDCache(test_dataset, device))
    if cfg.tile_cache == "on":
        raise RuntimeError("--tile-cache on: needs a single host, no --random-eraser and the "
                           "tiles within FCDGAN_TILE_CACHE_MAX_MB")
    feeds = ["native" if NativeOSCDBatchLoader.supports(ds) else "host"
             for ds in (dataset, test_dataset)]
    return feeds[0], feeds[1], None, None


def _loader(feed: str, ds, cache, batch_size: int, shuffle: bool, seed: int,
            tail: str = "short"):
    """The epoch batches of ``ds`` on its feed."""
    if cache is not None:
        return cache.loader(batch_size, shuffle=shuffle, seed=seed, tail=tail)
    if feed == "native":
        return NativeOSCDBatchLoader(ds, batch_size, shuffle=shuffle, seed=seed)
    return BatchLoader(ds, batch_size, fields=FIELDS, shuffle=shuffle, seed=seed, tail=tail)


def _accuracy(ev: Evaluator) -> Dict[str, float]:
    """Overall accuracy, kappa and F1 of an evaluator (F1 is NaN while no
    pixel is detected as changed)."""
    return {"oa": float(ev.Pixel_Accuracy()), "kappa": float(ev.Pixel_Kappa()),
            "f1": float(ev.Pixel_F1_score())}


def _scene_scalers(img_dir: str, txt_name: str, patch_size, stats_name: str) -> List:
    """Per-scene normalizers with cached ``{image}_{stats_name}.txt`` files
    beside the images (Demo_RSSS.py:75-97, demo_rsss.py:42-58); rank 0 of a
    process group writes the missing caches, the others read them."""
    with mesh.lead_first():
        return _read_scene_scalers(img_dir, txt_name, patch_size, stats_name)


def _read_scene_scalers(img_dir: str, txt_name: str, patch_size, stats_name: str) -> List:
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


def run_profiled(cfg) -> Dict:
    """``run`` under a ``torch.profiler`` trace when ``profile_dir`` is set,
    one trace per rank."""
    _check_supported(cfg)
    return mesh.run_world(_train_profiled, cfg)


def run(cfg: RSSSConfig) -> Dict:
    """The driver in the world its options ask for (``parallel.mesh``)."""
    _check_supported(cfg)
    return mesh.run_world(_train, cfg)


def _train_profiled(cfg: RSSSConfig) -> Dict:
    with maybe_profile(cfg.profile_dir, cuda=cfg.device != "cpu"):
        return _train(cfg)


def _train(cfg: RSSSConfig) -> Dict:
    device = resolve_device(cfg.device)
    dtype = _DTYPES[cfg.compute_dtype]
    torch.manual_seed(cfg.seed)
    out_dir = os.path.join(cfg.img_dir, "model{}".format(cfg.ext))
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(cfg.out_g_model_dir, exist_ok=True)

    # -- datasets with per-scene normalizers and their feed (Demo_RSSS.py:75-134)
    # the random eraser on the train scenes only (Demo_RSSS.py:96,128 wiring)
    eraser = build_eraser(cfg.random_eraser, cfg.eraser_regions, cfg.erase_thresh, cfg.seed)

    def scene_list(txt_name, transform=None):
        scalers = _scene_scalers(cfg.img_dir, txt_name, cfg.patch_size, cfg.stats_name)
        return OSCDDataset(cfg.img_dir, txt_name, scaler=scalers,
                           transforms=[transform] * len(scalers), patch_size=cfg.patch_size,
                           overlap_padding=cfg.overlap_padding)

    dataset, test_dataset = scene_list(cfg.txt_name, eraser), scene_list(cfg.test_txt_name)
    total, total_test = len(dataset), len(test_dataset)
    feed, test_feed, train_cache, test_cache = tile_feed(cfg, dataset, test_dataset, device)
    tail = batch_tail(cfg)
    init_loader = _loader(feed, dataset, train_cache, cfg.init_batch_size, True, cfg.seed, tail)
    train_loader = _loader(feed, dataset, train_cache, cfg.batch_size, True, cfg.seed + 1,
                           tail)
    test_loader = _loader(test_feed, test_dataset, test_cache, cfg.batch_size, False,
                          cfg.seed, tail)

    def put(batch, cache):
        batch = put_multihost(batch)  # this rank's slice of the global batch
        if cache is not None:
            return cache.complete(batch)
        return device_put_batch({k: batch[k] for k in FIELDS + ("weight",)}, device)

    # -- models / optimizers (Demo_RSSS.py:137-158) --------------------------
    nband = dataset.dslist[0].ds.raster_x.nband
    net_g = Generator(nband, compute_dtype=dtype)
    net_s = Segmentor(nband, compute_dtype=dtype, siamese_stats=cfg.siamese_stats)
    net_d = Discriminator(nband, compute_dtype=dtype, siamese_stats=cfg.siamese_stats)
    init_epochs_g = model_g_reuse(cfg.out_g_model_dir, net_g, cfg.init_num_epochs_g,
                                  cfg.model_g_reuse)
    for net in (net_g, net_s, net_d):
        net.to(device)
    vgg = VGG16Weights(load_vgg16_params(cfg.vgg_npz, require=cfg.require_vgg), device)
    opts = adam(net_g.parameters()), rmsprop(net_s.parameters()), rmsprop(net_d.parameters())
    steps = RSSSSteps(
        net_g, net_s, net_d, *opts, vgg,
        PerceptionConfig(select_feature_layers(cfg.perception_layer),
                         cfg.perception_per_band,
                         dtype=dtype if dtype == torch.bfloat16 else None),
        cfg.perception_weight, cfg.ssim_weight, cfg.g_weight, cfg.l1_weight,
        cfg.d_weight, cfg.r_weight, dataset.interior_sizes(), cfg.overlap_padding,
        cfg.gt_map, cfg.pre_map, cfg.prob_thresh, cfg.discriminator_continuous,
        cfg.msssim_weights, test_interior_sizes=test_dataset.interior_sizes(),
        ssim_metric=cfg.ssim_metric, remat=cfg.remat)
    g_nets = {"netG": (net_g, opts[0])}
    adv_nets = {**g_nets, "netS": (net_s, opts[1]), "netD": (net_d, opts[2])}
    ckpt = TrainCheckpointer(os.path.join(out_dir, "resume.ckpt"), cfg.checkpoint_every)
    starts = {"g": 0, "adv": 0}
    if cfg.resume and ckpt.exists():
        meta = ckpt.restore(adv_nets)
        starts = TrainCheckpointer.start_epochs(meta, ("g", "adv"))
        print("Resuming from phase {} epoch {}".format(meta["phase"], meta["epoch"]))

    def checked(step, phase, i, *nets):
        return nan_checked(step, phase, i, *nets) if cfg.debug_nans else step()

    writer = ScalarWriter(comment="RSSS_OSCD{}".format(cfg.ext),
                          enabled=cfg.log_tensorboard and mesh.writes())
    seconds = {"g": [], "adv": [], "test": [], "infer": 0.0}
    metrics = {"g": [], "adv": [], "test": []}

    # -- phase 1: G pretrain with region masks (Demo_RSSS.py:173-238) --------
    print("Start Generator Training")
    for i in range(starts["g"], init_epochs_g):
        t0 = time.perf_counter()
        lr = schedules.G_PRETRAIN(i / cfg.lr_epoch_scale) * cfg.lr_scale
        av = EpochAverages(total)
        prog = Progress(total, lambda: init_epochs_g - 1 - i, cfg.progress)
        for batch in prefetch(iter(init_loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put(batch, train_cache)
            bw = float(batch["weight"].sum())
            av.update(checked(lambda: steps.g_pretrain(db["x"], db["y"], db["region"],
                                                       db["weight"], lr), "g", i, net_g), bw)
            prog.end_batch(int(bw))
        prog.finish()
        print("Epochs: {}/{}, g_loss: {:.4f}, generator_loss: {:.4f}, "
              "perception_loss:{:.4f}, ssim_loss:{:.4f}".format(
                  i + 1, init_epochs_g, av["g_loss"], av["generator_loss"],
                  av["perception_loss"], av["ssim_loss"]))
        for k in G_KEYS:
            writer.add_scalar(k, av[k], i)
        ckpt.maybe_save("g", i, **g_nets)
        seconds["g"].append(time.perf_counter() - t0)
        metrics["g"].append(av.as_dict())

    # -- phase 2: adversarial + per-epoch test eval (Demo_RSSS.py:244-447) ---
    print("Start Adversarial Training")
    test_acc = None
    for i in range(starts["adv"], cfg.num_epochs):
        t0 = time.perf_counter()
        lr_s = schedules.S_ADV_RSSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        lr_d = schedules.D_ADV_RSSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        av = EpochAverages(total)
        prog = Progress(total, lambda: cfg.num_epochs - 1 - i, cfg.progress)
        for batch in prefetch(iter(train_loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put(batch, train_cache)
            bw = float(batch["weight"].sum())
            av.update(checked(lambda: steps.adversarial(
                db["x"], db["y"], db["ref"], db["region"], db["item"], db["weight"], lr_s,
                lr_d), "adv", i, net_s, net_d), bw)
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
        # trimmed to its real tiles, so train-mode BN sees no duplicates, on
        # one device; under a process group it keeps its padded tail
        # (demo_rsss.py:259-262)
        t0 = time.perf_counter()
        test_av = EpochAverages(1)
        evaluate = (steps.eval_confusion_train if cfg.test_eval_bn == "train"
                    else steps.eval_confusion)
        for batch in prefetch(iter(test_loader), cfg.prefetch_depth):
            n_real = int(np.asarray(batch["weight"]).sum())
            if (cfg.test_eval_bn == "train" and n_real < len(batch["weight"])
                    and not mesh.group_active()):
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
        ckpt.maybe_save("adv", i, **adv_nets)
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
        db = put(batch, test_cache)  # each rank its slice; gathered before the writes
        cmap = dequantize(quantize(mesh.gather(steps.infer(db["x"], db["y"])),
                                   cfg.density_dtype).cpu(), cfg.density_dtype)
        ref = mesh.gather(db["ref"]).cpu().numpy()
        if not mesh.writes():
            continue
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
    if cfg.save_checkpoints and mesh.writes():
        save_net(smodel_path, net_s)
        save_net(gmodel_path, net_g)
        save_net(dmodel_path, net_d)
    writer.close()
    para_path = os.path.join(out_dir, "Para.txt")
    if mesh.writes():
        write_para_txt(para_path, {
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
        "test_feed": test_feed,
        "start_epochs": starts,
    }


def main(argv=None) -> Dict:
    return run_profiled(parse_cli(RSSSConfig, argv))


if __name__ == "__main__":
    main()
