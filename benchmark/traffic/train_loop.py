"""Traffic driver ``train_loop``: a training phase of a driver loop, epoch
after epoch, through the driver's own feed.

Set-up makes the data from the seed (``synthetic``) and writes it as the
driver reads it, builds the program's networks, optimizers and step from
the configuration with weights from the seed (``weights``), and takes the
feed the driver would take (``demos.demo_usss.scene_feed`` or
``demos.demo_wsss.slice_feed``). One warm epoch (epoch 0) runs every
shape; its first three steps are kept for the check: their batch rows,
losses, the first gradient as the optimizer holds it, and the parameters
after the third. With ``--trace 1`` the first steps of the next epoch run
under the profiler. Then the window: whole epochs back to back, each batch
loaded, placed, stepped, and each epoch's averages read once, as the
driver does, for ``seconds``; the window's rate counts every item stepped
in it over its length, which ends on a synchronize. Set-up's objects are
frozen out of the garbage collector's passes in the window.

After the window the program's state is freed and the reference runs the
same three steps (``reference.train.first_steps``).

Parameters (the cell's ``params``): ``profile_steps``, and for ``usss``
``scene_px`` and ``rects``, for ``wsss`` ``n_changed`` and ``n_unchanged``.
"""

from __future__ import annotations

import gc
import os
import random
import time
from typing import Dict

import numpy as np
import torch

from .. import compare, synthetic, trace, work
from ..reference import models as ref_models
from ..reference import train as ref_train
from ..weights import DATA_SALT, generator, init_state

NETS = {"usss": ("G", "S"), "wsss": ("G", "S", "D")}
TRAINED = {"usss": ("G", "S"), "wsss": ("S", "D")}


def init_states(cfg: Dict, seed: int, device, names) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every network's starting state from the seed (one draw a network)."""
    with torch.device("meta"):
        shells = ref_models.nets(names, cfg["bands"])
    return {k: init_state(shells[k], seed, salt, device)
            for salt, k in enumerate(names)}


def _levels(cfg: Dict) -> int:
    w = cfg.get("msssim_weights")
    return work.MSSSIM_LEVELS if w is None else len(w)


class Feed:
    """Batches of the driver's loader epoch after epoch, read ahead as the
    driver reads them; ``next()`` is None at each epoch's end."""

    def __init__(self, loader, depth: int = 2):
        from fcdgan_tpu_torch.data.pipeline import prefetch

        self._prefetch = prefetch
        self.loader, self.depth, self.epoch, self.it = loader, depth, -1, None

    def next(self):
        if self.it is None:
            self.epoch += 1
            self.it = self._prefetch(iter(self.loader), self.depth)
        b = next(self.it, None)
        if b is None:
            self.it = None
        return b

    def close(self):
        """Let the read-ahead thread finish the epoch it is in."""
        if self.it is not None:
            for _ in self.it:
                pass
            self.it = None


def raw_data(r) -> Dict[str, np.ndarray]:
    """The cell's raw rasters from the seed: a uint16 scene pair and its
    change mask (usss), or uint8 changed and unchanged slice stacks and the
    changed slices' mask (wsss)."""
    cfg, gen = r.config, generator(r.seed, DATA_SALT, r.device)
    if cfg["mode"] == "usss":
        side = r.params["scene_px"]
        x, y, mask = synthetic.scene_pair(gen, side, side, cfg["bands"], r.params["rects"])
        return {"x": x, "y": y, "mask": mask}
    size, c = cfg["slice"], cfg["bands"]
    cx, cy, cmask = synthetic.slices(gen, cfg["n_changed"], size, c, True)
    nx, ny, _ = synthetic.slices(gen, cfg["n_unchanged"], size, c, False)
    return {"cx": cx, "cy": cy, "nx": nx, "ny": ny, "mask": cmask}


def reference_data(cfg: Dict, raw: Dict[str, np.ndarray]):
    """The reference's batch maker over the raw rasters."""
    if cfg["mode"] == "usss":
        return ref_train.SceneTiles(raw["x"], raw["y"], cfg["patch"], cfg["pad"])
    return ref_train.SlicePairs(raw["cx"], raw["cy"], raw["nx"], raw["ny"])


def _usss(r, dev, dtype, init, raw, vgg_params):
    from fcdgan_tpu_torch.config import USSSConfig
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.pipeline import device_put_batch
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.demos.demo_usss import scene_feed
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights
    from fcdgan_tpu_torch.train.optim import adam
    from fcdgan_tpu_torch.train.schedules import JOINT_USSS
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

    cfg = r.config
    c, patch, pad = cfg["bands"], cfg["patch"], cfg["pad"]
    x, y, mask = raw["x"], raw["y"], raw["mask"]
    paths = {k: os.path.join(r.workdir, f"{k}.tif") for k in ("T1", "T2", "ref")}
    synthetic.write_tiff(paths["T1"], x)
    synthetic.write_tiff(paths["T2"], y)
    synthetic.write_tiff(paths["ref"], mask + 1)
    stats_ds = ScenePairDataset(paths["T1"], paths["T2"], patch_size=(patch, patch),
                                overlap_padding=(0, 0))
    scaler = Normalize(*dataset_meanstd(os.path.join(r.workdir, "s1.txt"),
                                        os.path.join(r.workdir, "s2.txt"), stats_ds))
    dataset = ScenePairDataset(paths["T1"], paths["T2"], ref_path=paths["ref"], enhance=scaler,
                               patch_size=(patch, patch), overlap_padding=(pad, pad))
    g = Generator(c, compute_dtype=dtype).to(dev)
    s = Segmentor(c, compute_dtype=dtype).to(dev)
    g.load_state_dict(init["G"])
    s.load_state_dict(init["S"])
    perception = PerceptionConfig((cfg["vgg_tap"],), True,
                                  dtype=dtype if dtype == torch.bfloat16 else None)
    opt = {"G": adam(g.parameters()), "S": adam(s.parameters())}
    steps = USSSSteps(g, s, opt["G"], opt["S"], VGG16Weights(vgg_params, dev), perception,
                      cfg["perception_weight"], cfg["l1_weight"], cfg["ssim_weight"],
                      dataset.grid.interior_sizes(), (pad, pad),
                      msssim_weights=cfg.get("msssim_weights"))
    dcfg = USSSConfig(batch_size=cfg["batch"], seed=r.seed, scene_cache="auto", tail="short",
                      device=str(dev))
    _, cache, loader, placer = scene_feed(dcfg, dataset, scaler, dev)

    def put(b):
        if cache is not None:
            return cache.complete(b)
        db = device_put_batch(b, dev)
        return placer(db) if placer is not None else db

    def step(db, epoch):
        lr = JOINT_USSS(epoch)
        return steps.joint(db["x"], db["y"], db["ref"], db["item"], db["weight"], lr, lr)

    return dict(
        loader=loader, put=put, step=step, total=len(dataset), loss_key="NetLoss",
        losses=("NetLoss", "ssim_loss"), rows=("item", "weight"), nets={"G": g, "S": s},
        opt=opt, px_per_item=patch * patch,
        flops=lambda n: work.usss_joint_flops(n, patch, c, _levels(cfg)),
        launches=lambda n: work.usss_joint_launches(n, patch, c, cfg["compute_dtype"],
                                                    _levels(cfg)))


def _wsss(r, dev, dtype, init, raw, vgg_params):
    from fcdgan_tpu_torch.config import WSSSConfig
    from fcdgan_tpu_torch.data.datasets import WHUDataset, WHUPairDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.demos.demo_wsss import _put, slice_feed
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.models.vgg import VGG16Weights
    from fcdgan_tpu_torch.train import schedules
    from fcdgan_tpu_torch.train.optim import adam, rmsprop
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, WSSSSteps

    cfg = r.config
    size, c = cfg["slice"], cfg["bands"]
    cx, cy, cmask, nx, ny = (raw[k] for k in ("cx", "cy", "mask", "nx", "ny"))
    dirs = [os.path.join(r.workdir, d) for d in ("before", "after", "Label")]
    for d in dirs:
        os.makedirs(d)
    lines, zeros = [], np.zeros((size, size), np.uint8)
    for i, (a, b, label) in enumerate([(cx[k], cy[k], cmask[k] * 255) for k in range(len(cx))]
                                      + [(nx[k], ny[k], zeros) for k in range(len(nx))]):
        name = f"{i:05d}_0.tif"
        for d, img in zip(dirs, (a, b, label)):
            synthetic.write_tiff(os.path.join(d, name), img)
        lines.append(f"{name},0,0,{1 if i < len(cx) else 0}")
    with open(os.path.join(r.workdir, "label.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    args = (*dirs, r.workdir)
    scaler = Normalize(*dataset_meanstd(os.path.join(dirs[0], "stats_meanstd.txt"),
                                        os.path.join(dirs[1], "stats_meanstd.txt"),
                                        WHUDataset(*args, "-1")))
    pair_ds = WHUPairDataset(*args, scale=scaler, random_assign=False,
                             rng=random.Random(r.seed))
    dcfg = WSSSConfig(img_dir_x=dirs[0], img_dir_y=dirs[1], ref_dir=dirs[2],
                      label_dir=r.workdir, batch_size=cfg["batch"], seed=r.seed,
                      slice_cache="auto", tail="short", device=str(dev))
    _, _, cache, loader, _ = slice_feed(dcfg, pair_ds, scaler, dev)
    nets = {"G": Generator(c, compute_dtype=dtype).to(dev),
            "S": Segmentor(c, compute_dtype=dtype).to(dev),
            "D": Discriminator(c, compute_dtype=dtype).to(dev)}
    for k, net in nets.items():
        net.load_state_dict(init[k])
    opt = {"G": adam(nets["G"].parameters()), "S": rmsprop(nets["S"].parameters()),
           "D": rmsprop(nets["D"].parameters())}
    perception = PerceptionConfig((cfg["vgg_tap"],), False,
                                  dtype=dtype if dtype == torch.bfloat16 else None)
    steps = WSSSSteps(nets["G"], nets["S"], nets["D"], opt["G"], opt["S"], opt["D"],
                      VGG16Weights(vgg_params, dev), perception, cfg["perception_weight"],
                      cfg["ssim_weight"], cfg["g_weight"], cfg["l1_weight"], cfg["d_weight"],
                      cfg["nc_weight"], cfg["prob_thresh"],
                      msssim_weights=cfg.get("msssim_weights"))

    def put(b):
        if cache is not None:
            return cache.complete_pair(b)
        return _put(b, ("c_x", "c_y", "c_ref", "nc_x", "nc_y", "weight"), dev)

    def step(db, epoch):
        return steps.adversarial(db["c_x"], db["c_y"], db["c_ref"], db["nc_x"], db["nc_y"],
                                 db["weight"], schedules.S_ADV_WSSS(epoch),
                                 schedules.D_ADV_WSSS(epoch))

    return dict(
        loader=loader, put=put, step=step, total=len(pair_ds), loss_key="s_loss",
        losses=("d_loss", "s_loss", "ssim_loss"), rows=("c_item", "nc_item", "weight"),
        nets={"S": nets["S"], "D": nets["D"]}, opt={"S": opt["S"], "D": opt["D"]},
        px_per_item=2 * size * size,
        flops=lambda n: work.wsss_adversarial_flops(n, size, c, _levels(cfg)),
        launches=lambda n: work.wsss_adversarial_launches(n, size, c, cfg["compute_dtype"],
                                                          _levels(cfg)))


SETUPS = {"usss": _usss, "wsss": _wsss}


def _items(b) -> int:
    return int(np.asarray(b["weight"]).sum())


def run(r) -> Dict:
    from fcdgan_tpu_torch.train.loops import EpochAverages

    cfg, dev = r.config, torch.device(r.device)
    mode = cfg["mode"]
    dtype = getattr(torch, cfg["compute_dtype"])
    vgg_params = ref_models.vgg16_params(cfg["vgg_seed"])
    with r.phase("data"):
        init = init_states(cfg, r.seed, dev, NETS[mode])
        raw = raw_data(r)
    with r.phase("program"):
        s = SETUPS[mode](r, dev, dtype, init, raw, vgg_params)
    feed = Feed(s["loader"])
    state = {"av": EpochAverages(s["total"]), "items": 0, "steps": 0, "flops": 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one():
        """One batch stepped, or an epoch's averages read; the batch rows."""
        with r.timed("feed"):
            b = feed.next()
        if b is None:
            with r.timed("epoch_end"):
                state["av"][s["loss_key"]]
                state["av"].evaluator()
            state["av"] = EpochAverages(s["total"])
            return None
        with r.timed("put"):
            db = s["put"](b)
        with r.timed("dispatch"):
            m = s["step"](db, feed.epoch)
        n = _items(b)
        state["av"].update(m, float(n))
        state["items"] += n
        state["steps"] += 1
        state["flops"] += s["flops"](n)
        state["last"] = (b, m)
        return b

    # -- warm epoch; its first three steps are kept for the check -----------
    init_params = trained_params(mode, init)
    with r.phase("warm epoch"):
        kept = _warm_epoch(one, s, state, init_params)
        sync()

    # -- the profiled steps (--trace 1) --------------------------------------
    traced = None
    if r.trace:
        sizes = []
        with trace.Window(dev) as w:
            r.window = w
            one()  # the profiler's warm-up
            w.start()
            while len(sizes) < r.params["profile_steps"]:
                b = one()
                if b is not None:
                    sizes.append(_items(b))
        r.window = None
        traced = w.summary
        traced["units"] = len(sizes)
        traced["expected"] = work.by_group(
            [x for n in sizes for x in s["launches"](n)])
    r.spans.clear()
    for k in ("items", "steps", "flops"):
        state[k] = 0

    # -- the window -----------------------------------------------------------
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    t_start = time.perf_counter()
    setup_s = t_start - r.t0
    while time.perf_counter() - t_start < r.seconds:
        one()
    sync()
    window_s = time.perf_counter() - t_start
    feed.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    items, steps_run, flops = state["items"], state["steps"], state["flops"]
    spans = {k: list(v) for k, v in r.spans.items()}

    # -- the check: the reference's three steps ------------------------------
    gc.unfreeze()
    prog_change = compare.changes(kept["params"], init_params)
    px_per_item = s["px_per_item"]
    del s, state, feed, one
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref_train.first_steps(cfg, init, reference_data(cfg, raw), kept["rows"],
                                vgg_params, dev)
    detail = {}
    checks = compare.training_checks(kept["losses"], kept["grads"], prog_change, ref,
                                     init_params, detail)
    detail["numbers"] = checks
    return {"kind": "train", "setup_s": setup_s, "window_s": window_s,
            "window_px": items * px_per_item,
            "steps": steps_run, "attempted": steps_run, "failed": 0,
            "model_flops": flops, "spans": spans, "memory_peak_bytes": memory_peak,
            "trace": traced, "checks": checks, "detail": detail,
            "setup_phases": r.setup_phases}


def _warm_epoch(one, s: Dict, state: Dict, start: Dict[str, torch.Tensor]) -> Dict:
    """Epoch 0 to its end; of its first three steps the batch rows, the
    losses, the first gradient from the optimizers' state (``start``: the
    parameters before it), and the parameters after the third."""
    kept = {"rows": [], "losses": [], "grads": {}, "params": {}}
    while True:
        b = one()
        if b is None:
            return kept
        if len(kept["rows"]) == 3:
            continue
        m = state["last"][1]
        kept["rows"].append({k: np.array(b[k]) for k in s["rows"]})
        kept["losses"].append({k: float(m[k]) for k in s["losses"]})
        if len(kept["rows"]) == 1:
            for k, net in s["nets"].items():
                kept["grads"].update(compare.optimizer_grads(net, s["opt"][k], k, start))
        if len(kept["rows"]) == 3:
            kept["params"] = {f"{k}.{n}": p.detach().cpu().clone()
                              for k, net in s["nets"].items()
                              for n, p in net.named_parameters()}


def trained_params(mode: str, init) -> Dict[str, torch.Tensor]:
    """The starting parameters (no buffers) of the trained networks, on the
    host, by leaf name."""
    return {f"{k}.{n}": t.detach().cpu() for k in TRAINED[mode] for n, t in init[k].items()
            if not n.endswith(("running_mean", "running_var", "num_batches_tracked"))}
