"""Checkpoints as reference-format ``.pkl`` state_dicts.

The reference saves ``torch.save(net.state_dict(), 'SModel.pkl')``
(Demo_USSS.py:477-481, Demo_WSSS.py:454-461) and both packages read that
format. ``model_g_reuse`` is the WSSS generator-reuse shortcut. An orbax
``SModel.ckpt`` directory written by the JAX package is converted first with
``python -m fcdgan_tpu.tools.convert_checkpoint``.
"""

from __future__ import annotations

import os

import torch

from ..models.segmentor import Segmentor


def save_net(path: str, module: torch.nn.Module) -> None:
    """Write ``module``'s state_dict (on the CPU, f32 params) to ``path``."""
    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    torch.save(sd, path)


def model_g_reuse(g_model_dir: str, net_g: torch.nn.Module, init_num_epochs_g: int,
                  enabled: bool = True, name: str = "GModel.pkl") -> int:
    """Generator reuse (parity: Demo_WSSS.py:131-135, JAX checkpoint.py:
    164-183): when ``enabled`` and ``g_model_dir/name`` exists, its state_dict
    is loaded strictly into ``net_g`` and the pretrain epoch count becomes 0.
    Returns the epochs of G pretraining still to run."""
    path = os.path.join(g_model_dir, name)
    if enabled and os.path.isfile(path):
        net_g.load_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                              strict=True)
        return 0
    return init_num_epochs_g


def load_segmentor(path: str, device="cpu", compute_dtype=torch.float32,
                   bilinear: bool = True) -> Segmentor:
    """Eval-mode Segmentor on ``device`` with the weights of the ``.pkl``
    state_dict at ``path``, loaded strictly. The band count comes from the
    first conv's weight."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?); convert it to a "
            "state_dict .pkl with `python -m fcdgan_tpu.tools.convert_checkpoint`")
    if not bilinear:
        raise NotImplementedError(
            "only the bilinear Segmentor decoder is ported; every reference "
            "demo uses bilinear=True (Demo_USSS.py:110)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "inc.double_conv.0.weight" not in sd:
        raise ValueError(f"{path} does not hold a reference Segmentor state_dict")
    if "up1.up.weight" in sd:
        raise NotImplementedError(
            "ConvTranspose (bilinear=False) Segmentor checkpoints are not "
            "supported; every reference demo uses bilinear=True (Demo_USSS.py:110)")
    net = Segmentor(sd["inc.double_conv.0.weight"].shape[1],
                    compute_dtype=compute_dtype)
    net.load_state_dict(sd, strict=True)
    return net.to(device).eval()
