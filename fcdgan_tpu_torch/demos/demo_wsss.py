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
result's ``feed`` (the pair loader of the adversarial phase) and
``unc_feed`` (the unchanged slices of the G pretrain): ``resident`` (the raw
slice stacks on the device, ``--slice-cache auto|on`` within
``FCDGAN_SLICE_CACHE_MAX_MB``), else, each loader on its own, the native
slice loaders (``native``: ``NativeWHUPairBatchLoader`` and
``NativeWHUBatchLoader``, whose tails are wrap-padded), else the Python
``PairBatchLoader`` / ``BatchLoader`` (``host``). ``--random-eraser``
(on the unchanged slices) and ``--random-assign`` run on the Python loaders
only, as in the JAX package: the resident stacks refuse both, the native
loaders the eraser, the native pair loader a random pairing. The final
inference serves the changed slices from the resident stacks, or through
``BatchLoader``, with ``eval.inference.slice_inference``, which writes the
images on a writer thread while the next batch's forward runs
(demo_wsss.py:307-347).

The training options are the JAX driver's (see ``demo_usss``):
``--siamese-stats split`` (here for S and D), ``--remat``, ``--tail pad``,
``--checkpoint-every`` / ``--resume`` (``{out_dir}/resume.ckpt``),
``--profile-dir`` and ``--debug-nans``. ``--density-dtype`` is accepted and
read nowhere, as in the JAX driver: the density images are uint8.
``--n-devices`` and the multi-host options run as in ``demo_usss``: each
rank trains on its slice of every global batch, the resident stacks stay on
under ``--n-devices`` (off under multi-host), and the final train-mode
inference normalizes with the global batch statistics, its densities
gathered to every rank before the writes.

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

import torch

from ..config import WSSSConfig, batch_tail, check_training_options, parse_cli
from ..data.datasets import WHUDataset, WHUPairDataset
from ..data.erasers import build_eraser
from ..data.device_cache import DeviceWHUCache, IndexBatchLoader, IndexPairBatchLoader
from ..data.normalize import Normalize
from ..data.pipeline import (BatchLoader, NativeWHUBatchLoader, NativeWHUPairBatchLoader,
                             PairBatchLoader, device_put_batch, prefetch)
from ..data.raster import read_image
from ..data.stats import dataset_meanstd
from ..eval.inference import slice_inference
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
from ..train.steps import PerceptionConfig, WSSSSteps
from ..utils.device import resolve_device
from ..utils.timing import maybe_profile
from .demo_usss import _DTYPES, _log_accuracy

G_KEYS = ("g_loss", "generator_loss", "perception_loss", "ssim_loss")
ADV_KEYS = ("d_loss", "g_loss", "s_loss", "l1_loss", "nc_loss", "s_d_loss")


def _check_supported(cfg: WSSSConfig) -> None:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute-dtype must be one of {sorted(_DTYPES)}")
    check_training_options(cfg)
    if cfg.slice_cache not in ("auto", "on", "off"):
        raise ValueError(f"--slice-cache must be auto, on or off, not {cfg.slice_cache!r}")


FIELDS = ("x", "y", "ref", "item", "label")


def slice_feed(cfg: WSSSConfig, pair_ds, scaler, device, eraser=None):
    """(pair feed, unchanged feed, cache or None, pair loader, unchanged-slice
    loader) of the JAX driver's choice (demo_wsss.py:79-145): the resident
    stacks, else for each loader on its own the native slice loader, else
    the Python one. ``--slice-cache on`` raises when the stacks cannot be
    resident; multi-host takes no stacks (demo_wsss.py:91)."""
    dirs = (cfg.img_dir_x, cfg.img_dir_y, cfg.ref_dir, cfg.label_dir)
    reset = lambda e: pair_ds.order_reset()  # noqa: E731  re-pairs each epoch (Demo_WSSS.py:233)
    tail = batch_tail(cfg)
    if cfg.slice_cache != "off" and not mesh.multihost() and DeviceWHUCache.supports(pair_ds):
        cache = DeviceWHUCache(pair_ds, scaler, device)
        return ("resident", "resident", cache,
                IndexPairBatchLoader(pair_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                     epoch_hook=reset, tail=tail),
                IndexBatchLoader(pair_ds.nc_len, cfg.unc_batch_size, shuffle=True,
                                 seed=cfg.seed, tail=tail))
    if cfg.slice_cache == "on":
        raise RuntimeError("--slice-cache on: needs a single host, the fixed pairing, no "
                           "--random-eraser, and changed and unchanged slices within "
                           "FCDGAN_SLICE_CACHE_MAX_MB")
    unc_ds = WHUDataset(*dirs, scale=scaler, label_selected="0", transforms=eraser)
    if NativeWHUPairBatchLoader.supports(pair_ds):
        feed, pair_loader = "native", NativeWHUPairBatchLoader(
            pair_ds, cfg.batch_size, shuffle=True, seed=cfg.seed, epoch_hook=reset)
    else:
        feed, pair_loader = "host", PairBatchLoader(
            pair_ds, cfg.batch_size, c_fields=FIELDS, nc_fields=FIELDS, shuffle=True,
            seed=cfg.seed, epoch_hook=reset, tail=tail)
    if NativeWHUBatchLoader.supports(unc_ds):
        unc_feed, unc_loader = "native", NativeWHUBatchLoader(
            unc_ds, cfg.unc_batch_size, shuffle=True, seed=cfg.seed)
    else:
        unc_feed, unc_loader = "host", BatchLoader(
            unc_ds, cfg.unc_batch_size, fields=FIELDS, shuffle=True, seed=cfg.seed, tail=tail)
    return feed, unc_feed, None, pair_loader, unc_loader


def _put(batch, keys, device) -> dict:
    return device_put_batch({k: batch[k] for k in keys}, device)


def run_profiled(cfg) -> Dict:
    """``run`` under a ``torch.profiler`` trace when ``profile_dir`` is set,
    one trace per rank."""
    _check_supported(cfg)
    return mesh.run_world(_train_profiled, cfg)


def run(cfg: WSSSConfig) -> Dict:
    """The driver in the world its options ask for (``parallel.mesh``)."""
    _check_supported(cfg)
    return mesh.run_world(_train, cfg)


def _train_profiled(cfg: WSSSConfig) -> Dict:
    with maybe_profile(cfg.profile_dir, cuda=cfg.device != "cpu"):
        return _train(cfg)


def _train(cfg: WSSSConfig) -> Dict:
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
    with mesh.lead_first():  # one rank writes a missing cache, the others read it
        scaler = Normalize(*dataset_meanstd(sp1, sp2, stats_ds))

    # -- datasets and their feed (Demo_WSSS.py:84-92) -------------------------
    # the random eraser on the unchanged training slices (Demo_RSSS.py:96,128
    # wiring, CommonFunc.py:78-141)
    eraser = build_eraser(cfg.random_eraser, cfg.eraser_regions, cfg.erase_thresh, cfg.seed)
    pair_ds = WHUPairDataset(*dirs, scale=scaler, transforms=eraser,
                             random_assign=cfg.random_assign, rng=random.Random(cfg.seed))
    total = len(pair_ds)
    total_unc = pair_ds.nc_len
    feed, unc_feed, cache, pair_loader, unc_loader = slice_feed(cfg, pair_ds, scaler, device,
                                                                eraser)
    c_ds = pair_ds.c_ds

    def put_pair(batch):
        batch = put_multihost(batch)  # this rank's slice of the global batch
        if cache is not None:
            return cache.complete_pair(batch)
        return _put(batch, ("c_x", "c_y", "c_ref", "nc_x", "nc_y", "weight"), device)

    def put_unc(batch):
        batch = put_multihost(batch)
        if cache is not None:
            return cache.complete_unc(batch)
        return _put(batch, ("x", "y", "weight"), device)

    # -- models / optimizers (Demo_WSSS.py:103-122) --------------------------
    nband = read_image(c_ds.img_path_x[0]).shape[-1]
    net_g = Generator(nband, compute_dtype=dtype)
    net_s = Segmentor(nband, compute_dtype=dtype, siamese_stats=cfg.siamese_stats)
    net_d = Discriminator(nband, compute_dtype=dtype, siamese_stats=cfg.siamese_stats)
    # generator reuse (Demo_WSSS.py:131-138)
    init_epochs_g = model_g_reuse(cfg.out_g_model_dir, net_g, cfg.init_num_epochs_g,
                                  cfg.model_g_reuse)
    if cfg.g_weight == 0:
        init_epochs_g = 0
    for net in (net_g, net_s, net_d):
        net.to(device)
    vgg = VGG16Weights(load_vgg16_params(cfg.vgg_npz, require=cfg.require_vgg), device)
    opts = adam(net_g.parameters()), rmsprop(net_s.parameters()), rmsprop(net_d.parameters())
    steps = WSSSSteps(
        net_g, net_s, net_d, *opts, vgg,
        PerceptionConfig(select_feature_layers(cfg.perception_layer),
                         cfg.perception_per_band,
                         dtype=dtype if dtype == torch.bfloat16 else None),
        cfg.perception_weight, cfg.ssim_weight, cfg.g_weight, cfg.l1_weight,
        cfg.d_weight, cfg.nc_weight, cfg.prob_thresh, cfg.discriminator_continuous,
        cfg.msssim_weights, ssim_metric=cfg.ssim_metric, remat=cfg.remat)
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

    writer = ScalarWriter(comment="Building_WSSS{}".format(cfg.ext),
                          enabled=cfg.log_tensorboard and mesh.writes())
    seconds = {"g": [], "adv": [], "infer": 0.0}
    metrics = {"g": [], "adv": []}

    # -- phase 1: G pretrain on unchanged pairs (Demo_WSSS.py:140-204) -------
    print("Start Generator Training")
    for i in range(starts["g"], init_epochs_g):
        t0 = time.perf_counter()
        lr = schedules.G_PRETRAIN(i / cfg.lr_epoch_scale) * cfg.lr_scale
        av = EpochAverages(total_unc)
        prog = Progress(total_unc, lambda: init_epochs_g - 1 - i, cfg.progress)
        for batch in prefetch(iter(unc_loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put_unc(batch)
            bw = float(batch["weight"].sum())
            av.update(checked(lambda: steps.g_pretrain(db["x"], db["y"], db["weight"], lr),
                              "g", i, net_g), bw)
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

    # -- phase 2: adversarial S vs D (Demo_WSSS.py:208-385) ------------------
    print("Start Adversarial Training")
    for i in range(starts["adv"], cfg.num_epochs):
        t0 = time.perf_counter()
        lr_s = schedules.S_ADV_WSSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        lr_d = schedules.D_ADV_WSSS(i / cfg.lr_epoch_scale) * cfg.lr_scale
        av = EpochAverages(total)
        prog = Progress(total, lambda: cfg.num_epochs - 1 - i, cfg.progress)
        for batch in prefetch(iter(pair_loader), cfg.prefetch_depth):
            prog.start_batch()
            db = put_pair(batch)
            bw = float(batch["weight"].sum())
            av.update(checked(lambda: steps.adversarial(
                db["c_x"], db["c_y"], db["c_ref"], db["nc_x"], db["nc_y"], db["weight"],
                lr_s, lr_d), "adv", i, net_s, net_d), bw)
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
        ckpt.maybe_save("adv", i, **adv_nets)
        seconds["adv"].append(time.perf_counter() - t0)
        metrics["adv"].append(av.as_dict())

    # -- final inference on the CHANGED set, train-mode BN (Demo_WSSS.py:387-445)
    print("Saving Change Map and Model")
    print("Segmentation of Change")
    t0 = time.perf_counter()
    # the changed slices from the resident stacks, else through BatchLoader
    # (demo_wsss.py:297-305); with --tail pad the duplicates of a padded tail
    # enter S's batch statistics, as in the JAX driver, and are not written;
    # under a process group each rank runs its slice of the batch with the
    # global statistics, and the densities are gathered before the writes
    # (demo_wsss.py:318-327)
    tail = batch_tail(cfg)
    test_loader = (IndexBatchLoader(pair_ds.c_len, cfg.batch_size, tail=tail)
                   if cache is not None
                   else BatchLoader(c_ds, cfg.batch_size, fields=FIELDS, tail=tail))

    def place(batch, infer):  # every rank, in order (the gather)
        local = put_multihost(batch)
        db = cache.complete_c(local) if cache is not None else _put(local, ("x", "y"), device)
        return mesh.gather(infer(db["x"], db["y"]))

    res = slice_inference(
        c_ds, net_s, cfg.batch_size, device, out_dir,
        out_density_dir if cfg.write_grey else None, prob_thresh=cfg.prob_thresh,
        write_color=cfg.write_color, batches=test_loader, place=place,
        ref_of=(lambda batch, row, item: cache.cref_host[item, :, :, 0]) if cache is not None
        else None, prefetch_depth=cfg.prefetch_depth)
    acc = res["evaluator"]
    seconds["infer"] = time.perf_counter() - t0
    print("\rSegmentation, " + segmentation_summary(acc))
    print("\r" + "End of Saving", flush=True)

    # -- save + Para txt (Demo_WSSS.py:454-482) -------------------------------
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
        "unc_feed": unc_feed,
        "start_epochs": starts,
    }


def main(argv=None) -> Dict:
    return run_profiled(parse_cli(WSSSConfig, argv))


if __name__ == "__main__":
    main()
