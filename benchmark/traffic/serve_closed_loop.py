"""Traffic driver ``serve_closed_loop``: one client serves scene after scene
through the program's scene-serving path, each request sent when the last
one's density is written.

Set-up makes the cell's scene pairs from the seed (every seed the same
sizes, in its own order; uint16 GeoTIFFs), the per-scene statistics caches
through the program's ``data.stats.dataset_meanstd`` (as ``tools.infer``
makes them on a scene's first serving), and the eval-mode Segmentor with
weights from the seed; one pass over the list warms every shape. A request
opens the pair with its cached statistics, runs
``eval.inference.stitched_inference`` (raster read, normalization, upload,
the pass, download) and writes and closes the float32 density GeoTIFF; its
latency is that whole call. The window serves the list round robin for
``seconds``; the rate counts every scene pixel served over the window,
which ends when the last request returns. Before a scene is served again
its last density is removed, outside the request, so that each request
writes a new file as for a new scene: a file truncated and written again
is flushed to disk early (ext4's ``auto_da_alloc``), which a user serving
new scenes does not pay, and the run writes little to disk. Set-up's
objects are frozen out of the garbage collector's passes in the window.

The check: the last density written for each scene against the
reference's stitched density of the raw pair (``reference.serve``).

Parameters: ``scenes`` ([width, height] each), ``rects`` (change
rectangles as fractions of a scene: x, y, w, h), ``batch``, ``serve_bs``
(``FCDGAN_SERVE_BS``), ``profile_scenes``, ``weights`` (a ``weights``
scheme).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import compare, synthetic, trace, work
from ..reference import models as ref_models
from ..reference import serve as ref_serve
from ..weights import DATA_SALT, generator, init_state


@dataclasses.dataclass
class Scene:
    name: str
    x: np.ndarray  # (H, W, C) uint16, raw
    y: np.ndarray
    paths: Tuple[str, str]  # the pair's GeoTIFFs
    stats: Tuple[str, str]  # their statistics caches
    out: str  # the density GeoTIFF

    @property
    def px(self) -> int:
        return self.x.shape[0] * self.x.shape[1]

    def tiles(self, stride: int) -> int:
        return -(-self.x.shape[0] // stride) * -(-self.x.shape[1] // stride)


def scene_arrays(r) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """(name, x, y) of the cell's raw uint16 scene pairs from the seed, in
    serving order: every seed the same sizes, in an order of its own."""
    rng, gen = np.random.default_rng(r.seed), generator(r.seed, DATA_SALT, r.device)
    sizes = [tuple(s) for s in r.params["scenes"]]
    out = []
    for k in rng.permutation(len(sizes)):
        w, h = sizes[k]
        rects = [(int(fx * w), int(fy * h), int(fw * w), int(fh * h))
                 for fx, fy, fw, fh in r.params["rects"]]
        x, y, _ = synthetic.scene_pair(gen, h, w, r.config["bands"], rects)
        out.append((f"scene{k}", x, y))
    return out


def _scenes(r) -> List[Scene]:
    """The scene pairs written as GeoTIFFs, with their output paths."""
    out_dir = os.path.join(r.workdir, "out")
    os.makedirs(out_dir)
    scenes = []
    for name, x, y in scene_arrays(r):
        sc = Scene(name, x, y,
                   tuple(os.path.join(r.workdir, f"{name}_T{i}.tif") for i in (1, 2)),
                   tuple(os.path.join(r.workdir, f"{name}_T{i}_stats.txt") for i in (1, 2)),
                   os.path.join(out_dir, f"{name}_density.tif"))
        synthetic.write_tiff(sc.paths[0], x)
        synthetic.write_tiff(sc.paths[1], y)
        scenes.append(sc)
    return scenes


def _chunk_launches(sc: Scene, cfg: Dict, p: Dict) -> list:
    """The kernel launches of a scene's fused pass: ``serve_chunks``' chunks
    of max(batch, serve_bs) tiles (at most the scene's), the last one
    filled up."""
    n = sc.tiles(cfg["patch"] - 2 * cfg["pad"])
    bs = min(max(p["batch"], p["serve_bs"]), n)
    return -(-n // bs) * work.serve_chunk_launches(bs, cfg["patch"], cfg["bands"],
                                                   cfg["compute_dtype"])


def run(r) -> Dict:
    cfg, p = r.config, r.params
    saved = os.environ.get("FCDGAN_SERVE_BS")
    os.environ["FCDGAN_SERVE_BS"] = str(p["serve_bs"])
    try:
        return _run(r, cfg, p, torch.device(r.device))
    finally:
        if saved is None:
            os.environ.pop("FCDGAN_SERVE_BS", None)
        else:
            os.environ["FCDGAN_SERVE_BS"] = saved


def _run(r, cfg: Dict, p: Dict, dev) -> Dict:
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.normalize import Normalize
    from fcdgan_tpu_torch.data.stats import dataset_meanstd
    from fcdgan_tpu_torch.eval.inference import stitched_inference
    from fcdgan_tpu_torch.models.segmentor import Segmentor

    patch, pad, c = cfg["patch"], cfg["pad"], cfg["bands"]
    stride = patch - 2 * pad
    with r.phase("data"):
        scenes = _scenes(r)
    with r.phase("statistics"):
        for sc in scenes:
            dataset_meanstd(*sc.stats, ScenePairDataset(*sc.paths, patch_size=(patch, patch),
                                                        overlap_padding=(0, 0)))
    with torch.device("meta"):
        shell = ref_models.Segmentor(c)
    weights = init_state(shell, r.seed, 0, dev, p["weights"])
    model = Segmentor(c, compute_dtype=getattr(torch, cfg["compute_dtype"])).to(dev).eval()
    model.load_state_dict(weights)

    def serve(sc: Scene):
        with r.timed("open"):
            ds = ScenePairDataset(*sc.paths, out_path=sc.out,
                                  enhance=Normalize(*dataset_meanstd(*sc.stats, None)),
                                  patch_size=(patch, patch), overlap_padding=(pad, pad))
        with r.timed("stitched_inference"):
            stitched_inference(ds, model, p["batch"], dev, density_dtype="float32")

    with r.phase("warm pass"):
        for sc in scenes:  # every scene's shapes
            serve(sc)

    traced = None
    if r.trace:
        shown = scenes[:p["profile_scenes"]]
        with trace.Window(dev) as w:
            r.window = w
            serve(scenes[-1])  # the profiler's warm-up
            w.start()
            for sc in shown:
                serve(sc)
        r.window = None
        traced = dict(w.summary, units=len(shown), px=sum(sc.px for sc in shown),
                      expected=work.by_group([x for sc in shown
                                              for x in _chunk_launches(sc, cfg, p)]))
    r.spans.clear()

    latencies, px, flops, i = [], 0, 0.0, 0
    tile_flops = work.serve_tile_flops(patch, c)
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    t_start = time.perf_counter()
    setup_s = t_start - r.t0
    while time.perf_counter() - t_start < r.seconds:
        sc = scenes[i % len(scenes)]
        os.remove(sc.out)  # a new file, as for a new scene: no overwrite flushed early
        t = time.perf_counter()
        serve(sc)
        latencies.append(time.perf_counter() - t)
        px += sc.px
        flops += sc.tiles(stride) * tile_flops
        i += 1
    window_s = time.perf_counter() - t_start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    spans = {k: list(v) for k, v in r.spans.items()}
    gc.unfreeze()
    served = [np.array(synthetic.read_tiff(sc.out)[..., 0]) for sc in scenes]
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = ref_models.Segmentor(c).to(dev)
    ref.load_state_dict(weights)
    gap = max(compare.density_gap(d, ref_serve.density(ref, sc.x, sc.y, patch, pad, dev))
              for d, sc in zip(served, scenes))
    return {"kind": "serve", "setup_s": setup_s, "window_s": window_s, "window_px": px,
            "latencies_s": latencies, "attempted": len(latencies), "failed": 0,
            "model_flops": flops, "spans": spans, "memory_peak_bytes": memory_peak,
            "trace": traced, "checks": {"density_gap": gap}, "setup_phases": r.setup_phases}
