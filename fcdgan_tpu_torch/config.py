"""Driver configs and their command-line parsing.

``USSSConfig``, ``WSSSConfig`` and ``RSSSConfig`` carry the JAX package's
defaults (config.py:19-288, the constants of Demo_USSS.py:33-76,
Demo_WSSS.py:31-66 and Demo_RSSS.py:31-67) and ``device`` (``cuda`` unless
the caller asks for ``cpu``). ``device_normalize`` (USSS) and
``prefetch_depth`` (all three) are the JAX package's: the native raw-tile
feed normalizes on the device, and the host loaders run ``prefetch_depth``
batches ahead on a background thread. The JAX fields ``platform`` and
``learning_rate`` (which no phase reads: the schedules set every rate)
have no counterpart. Neither have ``eraser_regions`` and ``erase_thresh``,
which only the unported ``random_eraser`` reads, so their flags are
rejected.
``unported``, ``unported_wsss`` and ``unported_rsss`` name the options
whose values the port does not run yet; the drivers raise ``NotImplementedError`` for them.
``parse_cli`` is a copy of the JAX package's (:290-345): every dataclass
field becomes ``--field-name``, parsed by its resolved annotation (bools
accept 1/true/yes, tuples are comma-separated and cast per element).
"""

from __future__ import annotations

import argparse
import dataclasses
import types
import typing
from typing import List, Optional, Tuple


@dataclasses.dataclass
class USSSConfig:
    """Unsupervised mode (defaults: Demo_USSS.py:33-76)."""

    dir: str = "/data"
    image_x_name: str = "T1.tif"
    image_y_name: str = "T2.tif"
    ref_name: str = "ref.tif"
    outdir: Optional[str] = None  # None -> dir
    ext: str = ""
    cmap_name: str = "ChangeDensity"
    stats_name: str = "stats"

    init_num_epochs_g: int = 50
    init_num_epochs_s: int = 50
    num_epochs: int = 100
    batch_size: int = 10
    lr_scale: float = 1.0        # multiplies every phase schedule
    lr_epoch_scale: float = 1.0  # schedules read epoch / lr_epoch_scale

    perception_weight: float = 0.4
    l1_weight: float = 0.65
    ssim_weight: float = 0.0
    perception_per_band: bool = True
    perception_layer: int = 1

    patch_size: Tuple[int, int] = (220, 220)
    overlap_padding: Tuple[int, int] = (10, 10)
    gt_map: Tuple[int, int] = (1, 2)
    pre_map: Tuple[int, int] = (0, 1)
    prob_thresh: float = 0.5
    write_color: bool = True
    discriminator_continuous: bool = True
    tips: str = "eval_patch"

    msssim_weights: Optional[Tuple[float, ...]] = None
    device: str = "cuda"            # 'cpu' only on request
    compute_dtype: str = "float32"  # 'bfloat16' = mixed precision (f32 losses/BN)
    siamese_stats: str = "joint"    # 'split' is not ported
    density_dtype: str = "float32"  # quantized downloads are not ported
    # 'auto'/'on'/'off': ship raw integral tiles from the native loader and
    # normalize + pad-mask them on the device
    device_normalize: str = "auto"
    # 'auto' resident, else the rolling window, else the host loaders; 'on'
    # resident; 'window' the rolling window; 'off' the host loaders
    scene_cache: str = "auto"
    tail: str = "auto"              # 'auto'/'short': the true-size last batch
    remat: bool = False
    ssim_metric: bool = True        # False skips the MS-SSIM metric (weight 0 only)
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    seed: int = 0
    checkpoint_every: int = 0
    resume: bool = False
    n_devices: Optional[int] = None
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    vgg_npz: Optional[str] = None
    require_vgg: bool = False
    prefetch_depth: int = 2         # host batches read ahead of the device
    log_tensorboard: bool = True
    save_checkpoints: bool = True
    progress: bool = True


@dataclasses.dataclass
class WSSSConfig:
    """Weakly supervised mode (defaults: Demo_WSSS.py:31-66)."""

    img_dir_x: str = ""
    img_dir_y: str = ""
    ref_dir: str = ""
    label_dir: str = ""
    out_g_model_dir: str = ""
    ext: str = ""
    out_dir: Optional[str] = None  # None -> {label_dir}/Detection_WSS{ext}

    init_num_epochs_g: int = 50
    num_epochs: int = 50
    unc_batch_size: int = 50
    batch_size: int = 15
    lr_scale: float = 1.0        # multiplies every phase schedule
    lr_epoch_scale: float = 1.0  # schedules read epoch / lr_epoch_scale
    prob_thresh: float = 0.6
    tips: str = "train"

    perception_weight: float = 0.5
    ssim_weight: float = 0.0
    perception_per_band: bool = False
    perception_layer: int = 1

    g_weight: float = 0.2
    l1_weight: float = 1.6
    d_weight: float = 1.0
    nc_weight: float = 1.5

    write_grey: bool = True
    write_color: bool = True
    model_g_reuse: bool = True
    discriminator_continuous: bool = True
    stats_name: str = "stats"
    random_assign: bool = False     # True is not ported
    random_eraser: bool = False     # True is not ported

    msssim_weights: Optional[Tuple[float, ...]] = None
    device: str = "cuda"            # 'cpu' only on request
    compute_dtype: str = "float32"  # 'bfloat16' = mixed precision (f32 losses/BN)
    siamese_stats: str = "joint"    # 'split' is not ported
    density_dtype: str = "float32"  # quantized downloads are not ported
    slice_cache: str = "auto"       # 'auto' resident else host loaders; 'on'; 'off'
    tail: str = "auto"              # 'auto'/'short': the true-size last batch
    remat: bool = False
    ssim_metric: bool = True        # False skips the MS-SSIM metric (weight 0 only)
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    seed: int = 0
    checkpoint_every: int = 0
    resume: bool = False
    n_devices: Optional[int] = None
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    vgg_npz: Optional[str] = None
    require_vgg: bool = False
    prefetch_depth: int = 2         # host batches read ahead of the device
    log_tensorboard: bool = True
    save_checkpoints: bool = True
    progress: bool = True


@dataclasses.dataclass
class RSSSConfig:
    """Regional supervised mode (defaults: Demo_RSSS.py:31-67)."""

    img_dir: str = ""
    out_g_model_dir: str = ""
    txt_name: str = "train.txt"
    test_txt_name: str = "test.txt"
    out_name_density: str = "density"
    out_name_binary: str = "color"
    ext: str = ""

    init_num_epochs_g: int = 50
    num_epochs: int = 100
    init_batch_size: int = 20
    batch_size: int = 12
    lr_scale: float = 1.0        # multiplies every phase schedule
    lr_epoch_scale: float = 1.0  # schedules read epoch / lr_epoch_scale

    patch_size: Tuple[int, int] = (200, 200)
    overlap_padding: Tuple[int, int] = (10, 10)
    gt_map: Tuple[int, int] = (1, 2)
    pre_map: Tuple[int, int] = (0, 1)
    prob_thresh: float = 0.5
    tips: str = ""

    perception_weight: float = 0.1
    ssim_weight: float = 0.0
    perception_per_band: bool = True
    perception_layer: int = 1

    l1_weight: float = 0.02
    g_weight: float = 0.5
    d_weight: float = 1.0
    r_weight: float = 2.0

    write_color: bool = True
    model_g_reuse: bool = True
    discriminator_continuous: bool = True
    stats_name: str = "statsMS"
    # 'train' (reference parity: the per-epoch test eval runs train-mode BN,
    # Demo_RSSS.py:415, and the running statistics absorb the test batches)
    # or 'eval' (running-statistics evaluation)
    test_eval_bn: str = "train"
    random_eraser: bool = False     # True is not ported

    msssim_weights: Optional[Tuple[float, ...]] = None
    device: str = "cuda"            # 'cpu' only on request
    compute_dtype: str = "float32"  # 'bfloat16' = mixed precision (f32 losses/BN)
    siamese_stats: str = "joint"    # 'split' is not ported
    density_dtype: str = "float32"  # quantized downloads are not ported
    tile_cache: str = "auto"        # 'auto' resident else host loaders; 'on'; 'off'
    tail: str = "auto"              # 'auto'/'short': the true-size last batch
    remat: bool = False
    ssim_metric: bool = True        # False skips the MS-SSIM metric (weight 0 only)
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    seed: int = 0
    checkpoint_every: int = 0
    resume: bool = False
    n_devices: Optional[int] = None
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    vgg_npz: Optional[str] = None
    require_vgg: bool = False
    prefetch_depth: int = 2         # host batches read ahead of the device
    log_tensorboard: bool = True
    save_checkpoints: bool = True
    progress: bool = True


def _unported_common(cfg) -> List[str]:
    out = []
    if cfg.siamese_stats != "joint":
        out.append(f"--siamese-stats {cfg.siamese_stats}")
    if cfg.remat:
        out.append("--remat")
    if cfg.tail not in ("auto", "short"):
        out.append(f"--tail {cfg.tail}")
    if cfg.n_devices or cfg.coordinator_address or cfg.num_processes:
        out.append("multi-device and multi-host training (--n-devices, "
                   "--coordinator-address, --num-processes)")
    if cfg.checkpoint_every or cfg.resume:
        out.append("periodic checkpoints and resume (--checkpoint-every, --resume)")
    if cfg.density_dtype != "float32":
        out.append(f"--density-dtype {cfg.density_dtype}")
    if cfg.profile_dir:
        out.append("--profile-dir")
    if cfg.debug_nans:
        out.append("--debug-nans")
    return out


def unported(cfg: USSSConfig) -> List[str]:
    """The options of a USSS ``cfg`` whose values the port does not run yet."""
    return _unported_common(cfg)


def unported_wsss(cfg: WSSSConfig) -> List[str]:
    """The options of a WSSS ``cfg`` whose values the port does not run yet."""
    out = _unported_common(cfg)
    if cfg.random_assign:
        out.append("--random-assign")
    if cfg.random_eraser:
        out.append("--random-eraser")
    return out


def unported_rsss(cfg: RSSSConfig) -> List[str]:
    """The options of an RSSS ``cfg`` whose values the port does not run yet."""
    out = _unported_common(cfg)
    if cfg.random_eraser:
        out.append("--random-eraser")
    return out


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _tuple_parser(tp):
    """Comma-separated tuple parser casting per the annotation's element
    types (``Tuple[int, int]`` casts each to int, ``Tuple[float, ...]`` all to
    float; untyped tuples infer int-vs-float per token)."""
    el = typing.get_args(tp)

    def parse(s: str):
        toks = [t for t in s.split(",") if t != ""]
        if el and el[-1] is Ellipsis:
            return tuple(el[0](t) for t in toks)
        if el and len(el) == len(toks):
            return tuple(cast(t) for cast, t in zip(el, toks))
        return tuple(float(v) if "." in v else int(v) for v in toks)

    return parse


def _unwrap_optional(tp):
    """Optional[X] / X | None -> X (the non-None member)."""
    if typing.get_origin(tp) in (typing.Union, types.UnionType):
        non_none = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(non_none) == 1:
            return non_none[0]
    return tp


def parse_cli(config_cls, argv=None):
    """Build a ``config_cls`` instance from CLI flags."""
    hints = typing.get_type_hints(config_cls)
    ap = argparse.ArgumentParser(description=config_cls.__doc__)
    for f in dataclasses.fields(config_cls):
        name = "--" + f.name.replace("_", "-")
        tp = _unwrap_optional(hints[f.name])
        if tp is bool:
            parser = _parse_bool
        elif typing.get_origin(tp) is tuple or tp is tuple:
            parser = _tuple_parser(tp)
        elif tp in (int, float, str):
            parser = tp
        else:
            raise TypeError(f"{config_cls.__name__}.{f.name}: unsupported CLI field "
                            f"type {hints[f.name]!r}")
        ap.add_argument(name, type=parser, default=f.default)
    args = ap.parse_args(argv)
    return config_cls(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(config_cls)})
