"""Convert a VGG16 ``features`` state_dict to the ``.npz`` layout of
``models/vgg.load_vgg16_params`` (JAX ``tools/convert_vgg.py``).

The JAX tool loads torchvision's pretrained VGG16, which needs a download.
This one reads a state_dict file that the user supplies: torchvision's
``vgg16(...).features.state_dict()`` saved with ``torch.save`` (keys
``{i}.weight`` / ``{i}.bias``, i the layer's index in ``features``; a full
``vgg16`` state_dict's ``features.{i}.*`` keys are taken as well). The 13
convolutions, in index order, become ``conv{li}_kernel`` (HWIO, transposed
from OIHW, as the JAX layout stores them) and ``conv{li}_bias``; the port
and the JAX package then read the file through ``--vgg-npz`` or
``$FCDGAN_VGG16_NPZ`` for the reference's pretrained perception loss
(Loss.py:25). Host code: the file is read on the CPU, which is its job.

Run: ``python -m fcdgan_tpu_torch.tools.convert_vgg --state-dict vgg16_features.pth
--out vgg16_features.npz``
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

N_CONVS = 13


def convert(state_dict_path: str, out_path: str) -> int:
    """Write the ``.npz`` of the state_dict at ``state_dict_path``; returns
    the number of conv layers (13, else it raises)."""
    sd = torch.load(state_dict_path, map_location="cpu", weights_only=True)
    layers = {}
    for key, value in sd.items():
        m = re.fullmatch(r"(?:features\.)?(\d+)\.(weight|bias)", key)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = value
    convs = [layers[i] for i in sorted(layers) if layers[i]["weight"].dim() == 4]
    if len(convs) != N_CONVS or any(set(c) != {"weight", "bias"} for c in convs):
        raise ValueError(f"expected {N_CONVS} conv layers with weight and bias in "
                         f"{state_dict_path}, got {len(convs)}")
    params = {}
    for li, conv in enumerate(convs):
        k = conv["weight"].detach().float().numpy()  # (O, I, KH, KW)
        params[f"conv{li}_kernel"] = np.ascontiguousarray(np.transpose(k, (2, 3, 1, 0)))
        params[f"conv{li}_bias"] = conv["bias"].detach().float().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **params)
    print(f"wrote {len(convs)} conv layers to {out_path}")
    return len(convs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--state-dict", required=True,
                    help="a torch.save'd VGG16 features state_dict")
    ap.add_argument("--out", required=True, help="the .npz to write")
    a = ap.parse_args(argv)
    return convert(a.state_dict, a.out)


if __name__ == "__main__":
    main()
