"""Stitched scene inference from a saved SModel state_dict (the serving path).

Port of the JAX package's ``tools/infer.py`` in mode ``scene``, fused path
(:114-222): load ``SModel*.pkl``, keep the raster pair resident on the GPU,
run the eval-mode Segmentor over the overlap-tiled grid (parity: reference
data_utils.py:57-63,154-176), stitch the change-density GeoTIFF and, when a
reference raster is given, the {TN,FN,FP,TP} color raster and the metrics
(Demo_USSS.py:404-473 semantics). The summary JSON line has the JAX tool's
keys.

Run:
  python -m fcdgan_tpu_torch.tools.infer --dir /data --smodel SModel.pkl \\
      [--ref-name ref.tif] [--device cpu] [--compute-dtype float32]

Normalization stats are read from (or computed into) the same
``{image}_{stats}.txt`` caches the drivers use, so a pair already prepared
for training serves unchanged. An orbax ``SModel.ckpt`` from the JAX
package is converted first with ``python -m fcdgan_tpu.tools.convert_checkpoint``.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
    mode: str = "scene"                 # only 'scene' is ported
    dir: str = "."
    smodel: str = ""                    # path to SModel*.pkl (required)
    image_x_name: str = "T1.tif"
    image_y_name: str = "T2.tif"
    bn_mode: str = "eval"               # 'train' is not ported
    ref_name: str = ""                  # optional: enables metrics + color map
    outdir: str = ""                    # default: dir
    cmap_name: str = "ChangeDensity"
    ext: str = ""
    stats_name: str = "stats"
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
    density_dtype: str = "float32"      # quantized downloads are not ported
    device_feed: str = "auto"           # 'auto' = device-resident fused path
    n_devices: int = 0                  # multi-device serving is not ported


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fcdgan_tpu_torch yet; see ROADMAP.md "
        "(queue A, 'Serving: what the first slice leaves out')")


def _check_supported(cfg: InferConfig) -> None:
    if cfg.mode != "scene":
        raise _not_ported(f"mode {cfg.mode!r}")
    if cfg.bn_mode != "eval":
        raise _not_ported(f"--bn-mode {cfg.bn_mode}")
    if cfg.density_dtype != "float32":
        raise _not_ported(f"quantized download (--density-dtype {cfg.density_dtype})")
    if cfg.device_feed != "auto":
        raise _not_ported(f"the streaming path (--device-feed {cfg.device_feed})")
    if cfg.n_devices > 1:
        raise _not_ported("multi-device serving (--n-devices)")
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"--compute-dtype must be one of {sorted(_DTYPES)}")


def run(cfg: InferConfig) -> Dict:
    from ..data.datasets import ScenePairDataset
    from ..data.normalize import Normalize
    from ..data.raster import create_raster
    from ..data.stats import dataset_meanstd
    from ..eval.changemap import write_changemap_gdal
    from ..eval.evaluator import Evaluator
    from ..eval.inference import stitched_inference
    from ..eval.roc import RocCurve
    from ..io.checkpoint import load_segmentor
    from ..utils.device import resolve_device

    _check_supported(cfg)
    device = resolve_device(cfg.device)
    if not cfg.smodel:
        raise SystemExit("--smodel <SModel.pkl> is required")
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
    net = load_segmentor(cfg.smodel, device=device,
                         compute_dtype=_DTYPES[cfg.compute_dtype],
                         bilinear=cfg.bilinear)
    if net.inc.double_conv[0].in_channels != dataset.size()[2]:
        raise ValueError(f"{cfg.smodel} takes {net.inc.double_conv[0].in_channels} "
                         f"bands, the scene has {dataset.size()[2]}")

    res = stitched_inference(dataset, net, cfg.batch_size, device)
    density = res["density"]
    out = {"density_path": out_path, "color_path": None, "pixels": res["pixels"],
           "seconds": res["seconds"], "px_per_s": res["px_per_s"],
           "device": torch.cuda.get_device_name(device) if device.type == "cuda"
           else "cpu"}
    acc = roc = None
    if ref_path:
        acc = Evaluator(num_class=len(cfg.gt_map))
        roc = RocCurve()
        cmask_full = (density > cfg.prob_thresh).astype(np.int16)
        ref_full = dataset.raster_ref.read_block()[..., 0].astype(np.int16)
        if cfg.write_color:
            xs, ys, _ = dataset.size()
            codes = write_changemap_gdal(cmask_full[None], ref_full[None],
                                         write_color=True, ref_map=cfg.gt_map,
                                         dt_map=cfg.pre_map)
            with create_raster(out_color_path, xs, ys, 1, np.int32,
                               like=dataset.raster_x) as out_color:
                out_color.write_block(codes[0].astype(np.int32), 0, 0, band=0)
            out["color_path"] = out_color_path
        acc.add_batch_map(ref_full, cmask_full, list(cfg.gt_map), list(cfg.pre_map))
        roc.add_batch(density, ref_full == cfg.gt_map[1])
    dataset.close_outputs()
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


def main(argv=None):
    from ..config import parse_cli

    return run(parse_cli(InferConfig, argv))


if __name__ == "__main__":
    main()
