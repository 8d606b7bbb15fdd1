"""Traffic driver ``serve_slices``: one client serves WHU slice sets through
the program's slice-serving path, train-mode BN, each request sent when the
last one's images are written.

Set-up makes the cell's slice sets from the seed (each ``changed`` changed
and ``unchanged`` unchanged RGB pairs of the configuration's slice size, as
``synthetic.slices`` makes them, under names in a seeded order of their
own, with the label file that lists them), writes them as WHU slices
(before, after, Label), makes each set's statistics caches through the
program's ``data.stats.dataset_meanstd`` (as ``tools.infer --mode whu``
makes them), and builds the Segmentor with weights from the seed. One pass
over every set warms every shape. A request opens the set as
``tools.infer --mode whu --label-selected -1`` does (the listed slices, its
cached statistics) and runs ``eval.inference.slice_inference``: the slice
reads, the upload, the pass in batches of the configuration's batch with
S in train mode (each batch's own statistics, Demo_WSSS.py:389-391), the
download, and the density and eval images of every slice written; its
latency is that whole call. The window serves the sets round robin for
``seconds``; the rate counts every slice pixel served over the window,
which ends when the last request returns. Before a set is served again its
images are removed, outside the request, so that each request writes new
files. With ``--trace 1`` the first ``profile_sets`` sets run under the
profiler inside the program's recorder (``utils.timing.recording``), whose
spans go to the window as host spans and to the record (``program_spans``,
``counters``); the recorder is off in the timed window. Set-up's objects
are frozen out of the garbage collector's passes in the window.

The check: each set's densities as the program downloaded them in the
last request that served it, against the reference's train-mode densities
of the raw pairs in the same batches (``reference.serve_slices``).

Parameters: ``sets``, ``changed``, ``unchanged`` (per set),
``profile_sets``, ``weights`` (a ``weights`` scheme).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import compare, synthetic, trace, work, work_slices
from ..reference import models as ref_models
from ..reference import serve_slices as ref_serve
from ..weights import DATA_SALT, generator, init_state

STATS = "stats"  # tools.infer's statistics cache name in whu mode


@dataclasses.dataclass
class SliceSet:
    name: str
    names: List[str]  # the slices' file names, as x and y are stacked
    x: np.ndarray  # (N, H, W, C) uint8, raw
    y: np.ndarray
    dirs: Tuple[str, str, str, str]  # before, after, Label, the label file's directory
    out: Tuple[str, str]  # the eval images' directory, the densities'

    def clear(self) -> None:
        for d in self.out:
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)


def slice_arrays(r) -> List[Tuple[List[str], np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(names, x, y, masks, labels) of each set from the seed: the changed
    pairs then the unchanged ones, named in a seeded order."""
    cfg, p = r.config, r.params
    rng, gen = np.random.default_rng(r.seed), generator(r.seed, DATA_SALT, r.device)
    size, c, n = cfg["slice"], cfg["bands"], p["changed"] + p["unchanged"]
    out = []
    for _ in range(p["sets"]):
        cx, cy, cmask = synthetic.slices(gen, p["changed"], size, c, True)
        nx, ny, nmask = synthetic.slices(gen, p["unchanged"], size, c, False)
        names = [f"{k:05d}_0.tif" for k in rng.permutation(n)]
        labels = np.r_[np.ones(p["changed"], int), np.zeros(p["unchanged"], int)]
        out.append((names, np.concatenate([cx, nx]), np.concatenate([cy, ny]),
                    np.concatenate([cmask, nmask]), labels))
    return out


def _sets(r) -> List[SliceSet]:
    """The sets written as WHU slices with their label files."""
    sets = []
    for i, (names, x, y, masks, labels) in enumerate(slice_arrays(r)):
        root = os.path.join(r.workdir, f"set{i}")
        dirs = tuple(os.path.join(root, d) for d in ("before", "after", "Label")) + (root,)
        for d in dirs[:3]:
            os.makedirs(d)
        for k, name in enumerate(names):
            for d, img in zip(dirs, (x[k], y[k], masks[k] * 255)):
                synthetic.write_tiff(os.path.join(d, name), img)
        with open(os.path.join(root, "label.txt"), "w") as f:
            f.write("".join(f"{name},0,0,{lab}\n" for name, lab in zip(names, labels)))
        sc = SliceSet(f"set{i}", names, x, y, dirs,
                      (os.path.join(root, "Detection_serve"),
                       os.path.join(root, "Detection_serve_Density")))
        sc.clear()
        sets.append(sc)
    return sets


def run(r) -> Dict:
    from fcdgan_tpu_torch.data.datasets import WHUDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.eval.inference import slice_inference
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.utils import timing

    cfg, p, dev = r.config, r.params, torch.device(r.device)
    size, c, bs = cfg["slice"], cfg["bands"], cfg["batch"]
    with r.phase("data"):
        sets = _sets(r)

    def stats_paths(sc: SliceSet):
        return tuple(os.path.join(d, f"{STATS}_meanstd.txt") for d in sc.dirs[:2])

    with r.phase("statistics"):
        for sc in sets:
            dataset_meanstd(*stats_paths(sc), WHUDataset(*sc.dirs, "-1"))
    with torch.device("meta"):
        shell = ref_models.Segmentor(c)
    weights = init_state(shell, r.seed, 0, dev, p["weights"])
    model = Segmentor(c, compute_dtype=getattr(torch, cfg["compute_dtype"])).to(dev)
    model.load_state_dict(weights)
    last: Dict[str, Dict[int, np.ndarray]] = {}
    order: Dict[str, List[str]] = {}

    def serve(sc: SliceSet) -> int:
        """One request: the set opened and served; its slices."""
        with r.timed("open"):
            ds = WHUDataset(*sc.dirs, label_selected="-1",
                            scale=Normalize(*dataset_meanstd(*stats_paths(sc),
                                                             WHUDataset(*sc.dirs, "-1"))))
        with r.timed("slice_inference"):
            res = slice_inference(ds, model, bs, dev, *sc.out, train_bn=True,
                                  prob_thresh=cfg["prob_thresh"], keep_densities=True)
        last[sc.name] = res["densities"]
        order[sc.name] = [ds.get_file_name(i) for i in range(len(ds))]
        return res["slices"]

    with r.phase("warm pass"):
        for sc in sets:  # every shape
            serve(sc)

    traced, spans, counters = None, {}, {}
    if r.trace:
        shown = sets[:p["profile_sets"]]
        with trace.Window(dev) as w:
            r.window = w
            sets[-1].clear()
            serve(sets[-1])  # the profiler's warm-up
            for sc in shown:
                sc.clear()
            w.start()
            with timing.recording() as rec:
                served = sum(serve(sc) for sc in shown)
            for sp in rec.spans:
                w.host_span(sp.name, sp.start, sp.end)
                spans.setdefault(sp.name, []).append(sp.end - sp.start)
            counters = dict(rec.counters)
        r.window = None
        batches = [min(bs, len(sc.names) - k) for sc in shown
                   for k in range(0, len(sc.names), bs)]
        traced = dict(w.summary, units=len(shown), px=served * size * size,
                      expected=work.by_group([x for n in batches for x in
                                              work_slices.slice_pass_launches(
                                                  n, size, c, cfg["compute_dtype"])]))
    r.spans.clear()

    latencies, slices, i = [], 0, 0
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    t_start = time.perf_counter()
    setup_s = t_start - r.t0
    while time.perf_counter() - t_start < r.seconds:
        sc = sets[i % len(sets)]
        sc.clear()  # new files, as for a new set
        t = time.perf_counter()
        slices += serve(sc)
        latencies.append(time.perf_counter() - t)
        i += 1
    window_s = time.perf_counter() - t_start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_spans = {k: list(v) for k, v in r.spans.items()}
    gc.unfreeze()
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = ref_models.Segmentor(c).to(dev)
    ref.load_state_dict(weights)
    gap = 0.0
    for sc in sets:
        at = {name: k for k, name in enumerate(sc.names)}
        idx = [at[name] for name in order[sc.name]]
        want = ref_serve.densities(ref, sc.x[idx], sc.y[idx], bs, dev)
        got = np.stack([last[sc.name][k] for k in range(len(idx))])
        gap = max(gap, compare.density_gap(got, want))
    return {"kind": "serve", "setup_s": setup_s, "window_s": window_s,
            "window_px": slices * size * size, "latencies_s": latencies,
            "attempted": len(latencies), "failed": 0,
            "model_flops": slices * work_slices.slice_pass_flops(1, size, c),
            "spans": window_spans, "memory_peak_bytes": memory_peak, "trace": traced,
            "program_spans": spans, "counters": counters, "checks": {"density_gap": gap},
            "detail": {"counters": counters}, "setup_phases": r.setup_phases}
