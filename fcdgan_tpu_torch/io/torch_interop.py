"""Carry the JAX package's Segmentor, Generator and Discriminator weights
into the port.

The port's models use the reference ``Module.py`` key names
(``inc.double_conv.0.weight``, ``block2.conv1.weight``, ``net.3.weight``,
...), so reference ``SModel.pkl`` / ``GModel.pkl`` / ``DModel.pkl``
state_dicts load strictly with
``load_state_dict``. ``units`` is a copy of the JAX package's unit map
(``io/torch_interop.py::units``, :51-78): (unit type, torch prefix, flax
path) in reference order. ``DoubleConv`` Sequential indices are {0 conv,
1 bn, 3 conv, 4 bn} (Module.py:25-32, 43-46, 59-64, 85, 101-111); the
Generator is block1 Sequential(conv9x9, PReLU), block2-6 ResidualBlock
(conv1/bn1/prelu/conv2/bn2), block7 Sequential(conv, bn), block8 conv9x9
(Module.py:145-158, 174-181); the Discriminator is the ``net`` Sequential
with convs at {0, 2, 5, 8} and BNs at {3, 6, 9}, and ``classifier`` convs at
{1, 3} (Module.py:195-217).

Layouts: flax kernel (kh, kw, I, O) -> torch weight (O, I, kh, kw); flax BN
scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var;
PReLU ``alpha`` -> ``weight``; ``num_batches_tracked`` is emitted as int64 0.
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
    if kind == "segmentor":
        u = _doubleconv_units("inc.double_conv", "DoubleConv_0")
        for i in range(4):
            u += _doubleconv_units(f"down{i + 1}.maxpool_conv.1.double_conv",
                                   f"Down_{i}/DoubleConv_0")
        for i in range(4):
            u += _doubleconv_units(f"up{i + 1}.conv.double_conv", f"Up_{i}/DoubleConv_0")
        u.append(("conv", "outc.conv", "OutConv_0/TorchConv_0/Conv_0"))
        return u
    if kind == "generator":
        u = [("conv", "block1.0", "TorchConv_0/Conv_0"), ("prelu", "block1.1", "PReLU_0")]
        for i in range(5):
            b, f = f"block{i + 2}", f"ResidualBlock_{i}"
            u += [("conv", f"{b}.conv1", f"{f}/TorchConv_0/Conv_0"),
                  ("bn", f"{b}.bn1", f"{f}/BatchNorm_0/BatchNorm_0"),
                  ("prelu", f"{b}.prelu", f"{f}/PReLU_0"),
                  ("conv", f"{b}.conv2", f"{f}/TorchConv_1/Conv_0"),
                  ("bn", f"{b}.bn2", f"{f}/BatchNorm_1/BatchNorm_0")]
        u += [("conv", "block7.0", "TorchConv_1/Conv_0"),
              ("bn", "block7.1", "BatchNorm_0/BatchNorm_0"),
              ("conv", "block8", "TorchConv_2/Conv_0")]
        return u
    if kind == "discriminator":
        u = [("conv", f"net.{ti}", f"TorchConv_{i}/Conv_0")
             for i, ti in enumerate((0, 2, 5, 8))]
        u += [("bn", f"net.{ti}", f"BatchNorm_{i}/BatchNorm_0")
              for i, ti in enumerate((3, 6, 9))]
        u += [("conv", "classifier.1", "TorchConv_4/Conv_0"),
              ("conv", "classifier.3", "TorchConv_5/Conv_0")]
        return u
    raise ValueError(f"unknown model kind {kind!r}; expected segmentor, generator "
                     "or discriminator")


def _get(tree: Dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return np.array(tree, np.float32)  # a writable copy


def from_jax_variables(variables: Dict, kind: str = "segmentor") -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` nested dicts of arrays (a JAX
    Segmentor's, Generator's or Discriminator's variables, converted to
    numpy) -> the port's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for typ, tkey, fpath in units(kind):
        if typ == "prelu":
            out[f"{tkey}.weight"] = torch.from_numpy(_get(params, f"{fpath}/alpha"))
        elif typ == "conv":
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
