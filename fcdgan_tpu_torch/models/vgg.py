"""Frozen VGG16 features for the perception loss (parity: reference Loss.py:17-61).

Counterpart of the JAX package's ``models/vgg.py``. The reference taps
torchvision's pretrained VGG16 ``features`` at the post-ReLU indices
[29, 22, 15, 8, 3]. No pretrained weights ship with either package:
``load_vgg16_params`` reads a converted ``.npz`` (``--vgg-npz``, then
``$FCDGAN_VGG16_NPZ``) and otherwise falls back, with a warning, to
``vgg16_random_params``, whose numpy draws are those of the JAX package, so
both packages use the same arrays from the same seed.

``vgg16_features`` stops at the deepest requested tap and returns the taps
in the requested order, as float32 NHWC tensors. A 1-channel input (the
per-band perception loss) runs conv1_1 with its kernel summed over the three
input channels in f32 (vgg.py:303-313): the convolution of the band
replicated to RGB, without the replication. Convolutions are ``F.conv2d`` in
channels_last (the JAX VGG calls ``lax.conv`` itself); the pools are
``ops.pool_bwd.max_pool_2x2``: the ``phase_pool`` kernel forward, the
``pool_bwd`` kernel backward.
The weights are tensors without ``requires_grad``, so a backward through
the features computes the input gradient only.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.pool_bwd import max_pool_2x2

# (out_channels per conv layer, pool positions) of vgg16().features
_CFG: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M")

#: multi-layer tap list, deepest first (parity: Loss.py:30)
FEATURE_LAYER_LIST: Tuple[int, ...] = (29, 22, 15, 8, 3)

_WARNED_FALLBACK = False


def vgg16_random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Fixed-seed He-normal VGG16 conv weights (HWIO) and zero biases, drawn
    in the JAX package's order (vgg.py:169-180)."""
    rng = np.random.default_rng(seed)
    params = {}
    in_c = 3
    for li, c in enumerate([c for c in _CFG if c != "M"]):
        std = float(np.sqrt(2.0 / (in_c * 9)))
        params[f"conv{li}_kernel"] = rng.normal(0, std, (3, 3, in_c, c)).astype(np.float32)
        params[f"conv{li}_bias"] = np.zeros((c,), np.float32)
        in_c = c
    return params


def load_vgg16_params(path: Optional[str] = None, require: bool = False
                      ) -> Dict[str, np.ndarray]:
    """Converted torchvision weights from ``path``, else ``$FCDGAN_VGG16_NPZ``,
    else the fixed-seed random network (warned once per process;
    ``require=True`` raises instead)."""
    candidates = [c for c in (path, os.environ.get("FCDGAN_VGG16_NPZ")) if c]
    for c in candidates:
        if os.path.exists(c):
            with np.load(c) as z:
                return {k: z[k] for k in z.files}
    if require:
        raise FileNotFoundError(
            "no pretrained VGG16 weights found (searched: %s); pass --vgg-npz or "
            "set $FCDGAN_VGG16_NPZ to a vgg16_features.npz (VGG16_WEIGHTS.md)"
            % (", ".join(candidates) or "nothing"))
    global _WARNED_FALLBACK
    if not _WARNED_FALLBACK:
        _WARNED_FALLBACK = True
        print("WARNING fcdgan_tpu_torch: no pretrained VGG16 weights found; the "
              "perception loss uses a FIXED-SEED RANDOM VGG, not the reference's "
              "pretrained perceptual metric (Loss.py:25-28). Pass --vgg-npz, or "
              "--require-vgg true to fail instead (VGG16_WEIGHTS.md).",
              file=sys.stderr, flush=True)
    return vgg16_random_params()


def select_feature_layers(feature_layer: int) -> Tuple[int, ...]:
    """First N entries of the tap list, clamped to [1, 5] (Loss.py:32-34)."""
    n = max(1, min(int(feature_layer), 5))
    return FEATURE_LAYER_LIST[:n]


class VGG16Weights:
    """The conv weights on one device as frozen OIHW channels_last f32
    tensors, with their casts to the compute dtype cached."""

    def __init__(self, params: Dict[str, np.ndarray], device):
        self.device = torch.device(device)
        self._f32 = {}
        for li in range(sum(1 for c in _CFG if c != "M")):
            k = torch.from_numpy(np.ascontiguousarray(
                np.transpose(params[f"conv{li}_kernel"], (3, 2, 0, 1))))
            self._f32[li] = (k.to(self.device, memory_format=torch.channels_last),
                             torch.from_numpy(np.asarray(params[f"conv{li}_bias"],
                                                         np.float32)).to(self.device))
        self._cast = {}

    def get(self, li: int, dtype: torch.dtype, one_channel: bool = False):
        key = (li, dtype, one_channel)
        hit = self._cast.get(key)
        if hit is None:
            k, b = self._f32[li]
            if one_channel:  # conv of the band replicated to RGB, summed in f32
                k = k.sum(dim=1, keepdim=True)
            hit = self._cast[key] = (k.to(dtype, memory_format=torch.channels_last),
                                     b.to(dtype))
        return hit


def vgg16_features(x: torch.Tensor, weights: VGG16Weights, tap_indices: Sequence[int],
                   dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """NHWC input through VGG16 ``features`` up to the deepest tap; returns
    the tapped post-ReLU activations as float32 NHWC, in the order of
    ``tap_indices`` (torchvision sequential indices)."""
    taps = set(int(t) for t in tap_indices)
    deepest = max(taps)
    dtype = dtype or x.dtype
    h = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out: List[Tuple[int, torch.Tensor]] = []
    li = 0
    seq = 0
    for c in _CFG:
        if seq > deepest:
            break
        if c == "M":
            h = max_pool_2x2(h)
            seq += 1
            continue
        k, b = weights.get(li, dtype, one_channel=(li == 0 and h.shape[1] == 1))
        h = torch.relu(F.conv2d(h, k, b, padding=1))
        seq += 2
        if seq - 1 in taps:
            out.append((seq - 1, h.permute(0, 2, 3, 1).float()))
        li += 1
    order = {t: i for i, t in enumerate(tap_indices)}
    out.sort(key=lambda kv: order[kv[0]])
    return [t for _, t in out]
