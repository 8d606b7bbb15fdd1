"""Driver configs and their command-line parsing.

``USSSConfig``, ``WSSSConfig`` and ``RSSSConfig`` carry the JAX package's
defaults (config.py:19-288, the constants of Demo_USSS.py:33-76,
Demo_WSSS.py:31-66 and Demo_RSSS.py:31-67) and ``device`` (``cuda`` unless
the caller asks for ``cpu``). ``device_normalize`` (USSS) and
``prefetch_depth`` (all three) are the JAX package's: the native raw-tile
feed normalizes on the device, and the host loaders run ``prefetch_depth``
batches ahead on a background thread. The JAX fields ``platform`` and
``learning_rate`` (which no phase reads: the schedules set every rate)
have no counterpart, so their flags are rejected.
``n_devices``, ``coordinator_address``, ``num_processes`` and
``process_id`` are the JAX package's data-parallel and multi-host options
(``parallel.mesh``, ``parallel.multihost``); ``check_training_options``
checks their values and ``batch_tail`` pads the last batch under them.
``parse_cli`` is a copy of the JAX package's (:290-345): every dataclass
field becomes ``--field-name``, parsed by its resolved annotation (bools
accept 1/true/yes, tuples are comma-separated and cast per element).
"""

from __future__ import annotations

import argparse
import dataclasses
import types
import typing
from typing import Optional, Tuple


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
    siamese_stats: str = "joint"    # 'split': per-branch BN statistics (the reference)
    density_dtype: str = "float32"  # 'uint8'/'bfloat16': quantized density download
    # 'auto'/'on'/'off': ship raw integral tiles from the native loader and
    # normalize + pad-mask them on the device
    device_normalize: str = "auto"
    # 'auto' resident, else the rolling window, else the host loaders; 'on'
    # resident; 'window' the rolling window; 'off' the host loaders
    scene_cache: str = "auto"
    tail: str = "auto"              # 'auto'/'short': the true-size last batch; 'pad'
    remat: bool = False             # recompute the forwards in the backward
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
    random_assign: bool = False     # a random unchanged partner per access
    # random-erase augmentation of the unchanged training slices (the host
    # loaders only: the resident cache and the native loaders refuse it)
    random_eraser: bool = False
    eraser_regions: int = 1
    erase_thresh: float = 0.3

    msssim_weights: Optional[Tuple[float, ...]] = None
    device: str = "cuda"            # 'cpu' only on request
    compute_dtype: str = "float32"  # 'bfloat16' = mixed precision (f32 losses/BN)
    siamese_stats: str = "joint"    # 'split': per-branch BN statistics (the reference)
    density_dtype: str = "float32"  # accepted as in JAX; the slice images are uint8
    slice_cache: str = "auto"       # 'auto' resident else host loaders; 'on'; 'off'
    tail: str = "auto"              # 'auto'/'short': the true-size last batch; 'pad'
    remat: bool = False             # recompute the forwards in the backward
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
    # random-erase augmentation of the training scenes (the host loaders only)
    random_eraser: bool = False
    eraser_regions: int = 1
    erase_thresh: float = 0.3

    msssim_weights: Optional[Tuple[float, ...]] = None
    device: str = "cuda"            # 'cpu' only on request
    compute_dtype: str = "float32"  # 'bfloat16' = mixed precision (f32 losses/BN)
    siamese_stats: str = "joint"    # 'split': per-branch BN statistics (the reference)
    density_dtype: str = "float32"  # 'uint8'/'bfloat16': quantized density download
    tile_cache: str = "auto"        # 'auto' resident else host loaders; 'on'; 'off'
    tail: str = "auto"              # 'auto'/'short': the true-size last batch; 'pad'
    remat: bool = False             # recompute the forwards in the backward
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


def check_training_options(cfg) -> None:
    """The values of the training options every driver shares."""
    for name, value, values in (("siamese-stats", cfg.siamese_stats, ("joint", "split")),
                                ("tail", cfg.tail, ("auto", "short", "pad")),
                                ("density-dtype", cfg.density_dtype,
                                 ("float32", "uint8", "bfloat16"))):
        if value not in values:
            raise ValueError(f"--{name} must be one of {values}, not {value!r}")
    if cfg.checkpoint_every < 0:
        raise ValueError("--checkpoint-every must be 0 (off) or a positive epoch count")
    if cfg.n_devices is not None and cfg.n_devices < 0:
        raise ValueError(f"--n-devices must be 0 (off) or positive, not {cfg.n_devices}")
    if asks_multihost(cfg):
        if cfg.coordinator_address is None or cfg.process_id is None:
            raise ValueError(
                "multi-host needs --coordinator-address and --process-id "
                f"(got {cfg.coordinator_address!r}, {cfg.process_id!r})")
        if cfg.n_devices and cfg.n_devices != cfg.num_processes:
            raise ValueError(
                "multi-host runs one device per process: --n-devices must be unset or "
                f"equal --num-processes ({cfg.num_processes}), not {cfg.n_devices}")


def asks_multihost(cfg) -> bool:
    """Whether the config asks for a multi-host world (JAX: num_processes > 1)."""
    return bool(cfg.num_processes and cfg.num_processes > 1)


def data_parallel(cfg) -> bool:
    """Whether the config asks for a process group (JAX: a mesh)."""
    return bool(cfg.n_devices) or asks_multihost(cfg)


def batch_tail(cfg) -> str:
    """The tail of the drivers' loaders (JAX demo_usss.py:112-122): ``pad``
    wrap-pads the last batch with weight-0 duplicates, ``short`` runs it at
    its true size, and ``auto`` is ``short`` on one device and ``pad`` under
    ``--n-devices`` or multi-host (the fixed padded shape of a mesh)."""
    if cfg.tail == "short" or (cfg.tail == "auto" and not data_parallel(cfg)):
        return "short"
    return "pad"


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
