"""Carry the JAX package's Segmentor weights into the port's state_dict.

The port's Segmentor uses the reference ``Module.py`` key names
(``inc.double_conv.0.weight``, ...), so a reference ``SModel.pkl`` loads
strictly with ``load_state_dict``. ``units`` is a copy of the JAX package's
unit map (``io/torch_interop.py::units("segmentor")``): (unit type, torch
prefix, flax path) in reference order. ``DoubleConv`` Sequential indices are
{0 conv, 1 bn, 3 conv, 4 bn} (Module.py:25-32, 43-46, 59-64, 85, 101-111).

Layouts: flax kernel (kh, kw, I, O) -> torch weight (O, I, kh, kw); flax BN
scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var;
``num_batches_tracked`` is emitted as int64 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _doubleconv_units(tp: str, fp: str) -> List[Tuple[str, str, str]]:
    return [
        ("conv", f"{tp}.0", f"{fp}/TorchConv_0/Conv_0"),
        ("bn", f"{tp}.1", f"{fp}/BatchNorm_0/BatchNorm_0"),
        ("conv", f"{tp}.3", f"{fp}/TorchConv_1/Conv_0"),
        ("bn", f"{tp}.4", f"{fp}/BatchNorm_1/BatchNorm_0"),
    ]


def units(kind: str = "segmentor") -> List[Tuple[str, str, str]]:
    """(unit type, torch prefix, flax path) triples, in reference order."""
    if kind != "segmentor":
        raise NotImplementedError(
            f"only the segmentor is ported so far, not {kind!r} (ROADMAP.md)")
    u = _doubleconv_units("inc.double_conv", "DoubleConv_0")
    for i in range(4):
        u += _doubleconv_units(f"down{i + 1}.maxpool_conv.1.double_conv",
                               f"Down_{i}/DoubleConv_0")
    for i in range(4):
        u += _doubleconv_units(f"up{i + 1}.conv.double_conv", f"Up_{i}/DoubleConv_0")
    u.append(("conv", "outc.conv", "OutConv_0/TorchConv_0/Conv_0"))
    return u


def _get(tree: Dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return np.array(tree, np.float32)  # a writable copy


def from_jax_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` nested dicts of arrays (a JAX
    Segmentor's variables, converted to numpy) -> the port's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for typ, tkey, fpath in units("segmentor"):
        if typ == "conv":
            k = _get(params, f"{fpath}/kernel")
            out[f"{tkey}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
            out[f"{tkey}.bias"] = torch.from_numpy(_get(params, f"{fpath}/bias"))
        else:
            out[f"{tkey}.weight"] = torch.from_numpy(_get(params, f"{fpath}/scale"))
            out[f"{tkey}.bias"] = torch.from_numpy(_get(params, f"{fpath}/bias"))
            out[f"{tkey}.running_mean"] = torch.from_numpy(_get(stats, f"{fpath}/mean"))
            out[f"{tkey}.running_var"] = torch.from_numpy(_get(stats, f"{fpath}/var"))
            out[f"{tkey}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out
