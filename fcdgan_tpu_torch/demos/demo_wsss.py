"""Weakly supervised change detection driver (reference: Demo_WSSS.py).

Port of the JAX package's ``demos/demo_wsss.py``: stats pass over every
listed WHU slice -> the feed -> G pretrain on the unchanged slices
(skipped when ``GModel.pkl`` is reused or ``g_weight`` is 0) -> adversarial
S vs D epochs over changed/unchanged pairs re-paired each epoch -> the
final inference over the changed slices with S in train mode (its BN
running statistics move, before SModel is saved, as in the reference) ->
one density map and one change map per changed slice, under
the slice's own file name -> ``Para.txt`` and ``SModel.pkl`` /
``DModel.pkl`` (``out_dir``) and ``GModel.pkl`` (``out_g_model_dir``),
reference state_dicts.

The feed is the JAX driver's choice (demo_wsss.py:79-145), named in the
result's ``feed``: ``resident`` (the raw slice stacks on the device,
``--slice-cache auto|on`` within ``FCDGAN_SLICE_CACHE_MAX_MB``), else the
native slice loaders (``native``: ``NativeWHUPairBatchLoader`` and
``NativeWHUBatchLoader``, whose tails are wrap-padded), else the Python
``PairBatchLoader`` / ``BatchLoader`` (``host``). The final inference reads
the changed slices from the resident stacks, or through ``BatchLoader``.

Run (on the GPU unless ``--device cpu``):

    python -m fcdgan_tpu_torch.demos.demo_wsss --img-dir-x /whu/before \\
        --img-dir-y /whu/after --ref-dir /whu/Label --label-dir /whu \\
        --out-g-model-dir /whu/GModel

``run`` returns the JAX driver's result dict (demo_wsss.py:375-386), with
the trained modules under ``sstate`` / ``gstate`` / ``dstate`` and, in
addition, each epoch's averaged metrics (``epoch_metrics``) and the wall
seconds of every epoch of each phase and of the inference
(``epoch_seconds``), each ending when its metrics reached the host.
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict

import numpy as np
import torch

from ..config import WSSSConfig, parse_cli, unported_wsss
from ..data.datasets import WHUDataset, WHUPairDataset
from ..data.device_cache import DeviceWHUCache, IndexBatchLoader, IndexPairBatchLoader
from ..data.normalize import Normalize
from ..data.pipeline import (BatchLoader, NativeWHUBatchLoader, NativeWHUPairBatchLoader,
                             PairBatchLoader, device_put_batch, prefetch)
from ..data.raster import read_image, write_image
from ..data.stats import dataset_meanstd
from ..eval.changemap import write_changemap
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
from ..train.steps import PerceptionConfig, WSSSSteps
from ..utils.device import resolve_device
from .demo_usss import _DTYPES, _log_accuracy

G_KEYS = ("g_loss", "generator_loss", "perception_loss", "ssim_loss")
ADV_KEYS = ("d_loss", "g_loss", "s_loss", "l1_loss", "nc_loss", "s_d_loss")


def _check_supported(cfg: WSSSConfig) -> None:
    missing = unported_wsss(cfg)
    if missing:
        raise NotImplementedError(
            "not ported to fcdgan_tpu_torch yet: {}; see ROADMAP.md (queue A, "
            "'Training: what the WSSS slice leaves out')".format("; ".join(missing)))
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute-dtype must be one of {sorted(_DTYPES)}")
    if cfg.slice_cache not in ("auto", "on", "off"):
        raise ValueError(f"--slice-cache must be auto, on or off, not {cfg.slice_cache!r}")


FIELDS = ("x", "y", "ref", "item", "label")


def slice_feed(cfg: WSSSConfig, pair_ds, scaler, device):
    """(feed name, cache or None, pair loader, unchanged-slice loader) of the
    JAX driver's choice (demo_wsss.py:79-145): the resident stacks, else the
    native slice loaders, else the Python loaders. ``--slice-cache on``
    raises when the stacks cannot be resident."""
    dirs = (cfg.img_dir_x, cfg.img_dir_y, cfg.ref_dir, cfg.label_dir)
    reset = lambda e: pair_ds.order_reset()  # noqa: E731  re-pairs each epoch (Demo_WSSS.py:233)
    if cfg.slice_cache != "off" and DeviceWHUCache.supports(pair_ds):
        cache = DeviceWHUCache(pair_ds, scaler, device)
        return ("resident", cache,
                IndexPairBatchLoader(pair_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                     epoch_hook=reset),
                IndexBatchLoader(pair_ds.nc_len, cfg.unc_batch_size, shuffle=True,
                                 seed=cfg.seed))
    if cfg.slice_cache == "on":
        raise RuntimeError("--slice-cache on: needs changed and unchanged slices within "
                           "FCDGAN_SLICE_CACHE_MAX_MB")
    unc_ds = WHUDataset(*dirs, scale=scaler, label_selected="0")
    if all(NativeWHUBatchLoader.supports(ds) for ds in (pair_ds.c_ds, unc_ds)):
        return ("native", None,
                NativeWHUPairBatchLoader(pair_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                         epoch_hook=reset),
                NativeWHUBatchLoader(unc_ds, cfg.unc_batch_size, shuffle=True, seed=cfg.seed))
    return ("host", None,
            PairBatchLoader(pair_ds, cfg.batch_size, c_fields=FIELDS, nc_fields=FIELDS,
                            shuffle=True, seed=cfg.seed, epoch_hook=reset, tail="short"),
            BatchLoader(unc_ds, cfg.unc_batch_size, fields=FIELDS, shuffle=True, seed=cfg.seed,
                        tail="short"))


def _put(batch, keys, device) -> dict:
    return device_put_batch({k: batch[k] for k in keys}, device)


def run(cfg: WSSSConfig) -> Dict:
    _check_supported(cfg)
    device = resolve_device(cfg.device)
    dtype = _DTYPES[cfg.compute_dtype]
    torch.manual_seed(cfg.seed)
    out_dir = cfg.out_dir or os.path.join(cfg.label_dir, "Detection_WSS{}".format(cfg.ext))
    out_density_dir = out_dir + "_Density"
    os.makedirs(out_dir, exist_ok=True)
    if cfg.write_grey:
        os.makedirs(out_density_dir, exist_ok=True)
    os.makedirs(cfg.out_g_model_dir, exist_ok=True)
    dirs = (cfg.img_dir_x, cfg.img_dir_y, cfg.ref_dir, cfg.label_dir)

    # -- stats + normalizer (Demo_WSSS.py:70-78) -----------------------------
    stats_ds = WHUDataset(*dirs, "-1")
    sp1 = os.path.join(cfg.img_dir_x, "{}_meanstd.txt".format(cfg.stats_name))
    sp2 = os.path.join(cfg.img_dir_y, "{}_meanstd.txt".format(cfg.stats_name))
    scaler = Normalize(*dataset_meanstd(sp1, sp2, stats_ds))

    # -- datasets and their feed (Demo_WSSS.py:84-92) -------------------------
    pair_ds = WHUPairDataset(*dirs, scale=scaler, rng=random.Random(cfg.seed))
    total = len(pair_ds)
    total_unc = pair_ds.nc_len
    feed, cache, pair_loader, unc_loader = slice_feed(cfg, pair_ds, scaler, device)
    c_ds = pair_ds.c_ds

    def put_pair(batch):
        if cache is not None:
            return cache.complete_pair(batch)
        return _put(batch, ("c_x", "c_y", "c_ref", "nc_x", "nc_y", "weight"), device)

    def put_unc(batch):
        if cache is not None:
            return cache.complete_unc(batch)
        return _put(batch, ("x", "y", "weight"), device)

    # -- models / optimizers (Demo_WSSS.py:103-122) --------------------------
    nband = read_image(c_ds.img_path_x[0]).shape[-1]
    net_g = Generator(nband, compute_dtype=dtype)
    net_s = Segmentor(nband, compute_dtype=dtype)
    net_d = Discriminator(nband, compute_dtype=dtype)
    # generator reuse (Demo_WSSS.py:131-138)
    init_epochs_g = model_g_reuse(cfg.out_g_model_dir, net_g, cfg.init_num_epochs_g,
                                  cfg.model_g_reuse)
    if cfg.g_weight == 0:
        init_epochs_g = 0
    for net in (net_g, net_s, net_d):
        net.to(device)
    vgg = VGG16Weights(load_vgg16_params(cfg.vgg_npz, require=cfg.require_vgg), device)
    steps = WSSSSteps(
        net_g, net_s, net_d, adam(net_g.parameters()), rmsprop(net_s.parameters()),
        rmsprop(net_d.parameters()), vgg,
        PerceptionConfig(select_feature_layers(cfg.perception_layer),
                         cfg.perception_per_band,
                         dtype=dtype if dtype == torch.bfloat16 else None),
        cfg.perception_weight, cfg.ssim_weight, cfg.g_weight, cfg.l1_weight,
        cfg.d_weight, cfg.nc_weight, cfg.prob_thresh, cfg.discriminator_continuous,
        cfg.msssim_weights, ssim_metric=cfg.ssim_metric)
    writer = ScalarWriter(comment="Building_WSSS{}".format(cfg.ext),
                          enabled=cfg.log_tensorboard)
    seconds = {"g": [], "adv": [], "infer": 0.0}
    metrics = {"g": [], "adv": []}

    # -- phase 1: G pretrain on unchanged pairs (Demo_WSSS.py:140-204) -------
    print("Start Generator Training")
    for i in range(init_epochs_g):
        t0 = time.perf_counter()
        lr = schedules.G_PRETRAIN(i / cfg.lr_epoch_scale) * cfg.lr_scale
        av = EpochAverages(total_unc)
        prog = Progress(total_unc, lambda: init_epochs_g - 1 - i, cfg.progress)
        for batch in prefetch(iter(unc_loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put_unc(batch)
            bw = float(batch["weight"].sum())
            av.update(steps.g_pretrain(db["x"], db["y"], db["weight"], lr), bw)
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

    # -- phase 2: adversarial S vs D (Demo_WSSS.py:208-385) ------------------
    print("Start Adversarial Training")
    for i in range(cfg.num_epochs):
        t0 = time.perf_counter()
        lr_s = schedules.S_ADV_WSSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        lr_d = schedules.D_ADV_WSSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        av = EpochAverages(total)
        prog = Progress(total, lambda: cfg.num_epochs - 1 - i, cfg.progress)
        for batch in prefetch(iter(pair_loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put_pair(batch)
            bw = float(batch["weight"].sum())
            av.update(steps.adversarial(db["c_x"], db["c_y"], db["c_ref"], db["nc_x"],
                                        db["nc_y"], db["weight"], lr_s, lr_d), bw)
            prog.end_batch(int(bw))
        prog.finish()
        ev = av.evaluator(2)
        print("Epochs: {}/{}, d_loss: {:.4f}, g_loss: {:.4f}, s_loss: {:.4f}, "
              "l1_loss:{:.4f}, nc_loss:{:.4f}, s_d_loss: {:.4f}".format(
                  i + 1, cfg.num_epochs, av["d_loss"], av["g_loss"], av["s_loss"],
                  av["l1_loss"], av["nc_loss"], av["s_d_loss"]))
        print(accuracy_line(i, cfg.num_epochs, ev))
        step = i + init_epochs_g
        for k in ADV_KEYS + ("generator_loss", "perception_loss", "ssim_loss"):
            writer.add_scalar(k, av[k], step)
        _log_accuracy(writer, ev, step)
        seconds["adv"].append(time.perf_counter() - t0)
        metrics["adv"].append(av.as_dict())

    # -- final inference on the CHANGED set, train-mode BN (Demo_WSSS.py:387-445)
    print("Saving Change Map and Model")
    print("Segmentation of Change")
    t0 = time.perf_counter()
    acc = Evaluator(num_class=2)
    # the changed slices from the resident stacks, else through BatchLoader
    # (demo_wsss.py:297-305)
    test_loader = (IndexBatchLoader(pair_ds.c_len, cfg.batch_size) if cache is not None
                   else BatchLoader(c_ds, cfg.batch_size, fields=FIELDS, tail="short"))
    for batch in prefetch(iter(test_loader), cfg.prefetch_depth):
        db = cache.complete_c(batch) if cache is not None else _put(batch, ("x", "y"), device)
        cmap = steps.infer_train_mode(db["x"], db["y"])[..., 0].cpu().numpy()
        cmask = (cmap > cfg.prob_thresh).astype(np.int16)
        for ns, item in enumerate(batch["item"]):
            item = int(item)
            if cache is not None:
                ref_mask = cache.cref_host[item, :, :, 0].astype(np.int16)
            else:
                ref_mask = batch["ref"][ns][:, :, 0].astype(np.int16)
            acc.add_batch_map(ref_mask, cmask[ns])
            name = c_ds.get_file_name(int(item))
            if cfg.write_grey:
                write_image(os.path.join(out_density_dir, name),
                            np.uint8(cmap[ns] * 255))
            change_write = write_changemap(cmask[ns], ref_mask, cfg.write_color)
            if change_write.ndim == 3:
                change_write = change_write.transpose((1, 2, 0))
            write_image(os.path.join(out_dir, name), np.uint8(change_write))
    seconds["infer"] = time.perf_counter() - t0
    print("\rSegmentation, " + segmentation_summary(acc))
    print("\r" + "End of Saving", flush=True)

    # -- save + Para txt (Demo_WSSS.py:454-482) -------------------------------
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
        "nc_weight": cfg.nc_weight,
        "d_weight": cfg.d_weight,
        "g_weight": cfg.g_weight,
        "discriminator_continuous": cfg.discriminator_continuous,
        "prob_thresh": cfg.prob_thresh,
    }, acc=acc, tips=cfg.tips)
    return {
        "evaluator": acc,
        "out_dir": out_dir,
        "density_dir": out_density_dir if cfg.write_grey else None,
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
        "pairs": total,
        "changed": pair_ds.c_len,
        "unchanged": pair_ds.nc_len,
        "feed": feed,
    }


def main(argv=None) -> Dict:
    return run(parse_cli(WSSSConfig, argv))


if __name__ == "__main__":
    main()
