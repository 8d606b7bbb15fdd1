"""Checkpoints as reference-format ``.pkl`` state_dicts, and resumable runs.

The reference saves ``torch.save(net.state_dict(), 'SModel.pkl')``
(Demo_USSS.py:477-481, Demo_WSSS.py:454-461) and both packages read that
format. ``model_g_reuse`` is the WSSS generator-reuse shortcut. An orbax
``SModel.ckpt`` directory written by the JAX package is converted first with
``python -m fcdgan_tpu.tools.convert_checkpoint``; ``TrainCheckpointer``
follows the JAX one's protocol with ``torch.save`` files (it reads and
writes no orbax).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models.segmentor import Segmentor
from ..parallel import mesh
from ..train import optim


def save_net(path: str, module: torch.nn.Module) -> None:
    """Write ``module``'s state_dict (on the CPU, f32 params) to ``path``."""
    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    torch.save(sd, path)


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class TrainCheckpointer:
    """Periodic in-training checkpoints, every phase resumable at epoch
    granularity (JAX ``io/checkpoint.py`` ``TrainCheckpointer``, :88-163).

    ``maybe_save(phase, epoch, name=(module, optimizer), ...)`` writes, after
    every ``every``-th epoch of a phase, one ``{name}.pt`` per net holding its
    ``state_dict`` (parameters and BatchNorm buffers) and its optimizer's
    (``train.optim.state_dict``: an Adam a CUDA graph made capturable is
    saved as the plain one, so the file loads on any device), then ``meta.json`` with ``{"phase", "epoch"}`` (each file written to a
    temporary name and moved into place). ``restore`` loads them into the
    caller's modules and optimizers and returns the meta record, from which
    ``start_epochs`` gives each phase's first epoch. As in the JAX package,
    the data order is not saved: a resumed run re-derives its shuffles from
    the seed (the documented approximation). Under ``--n-devices`` rank 0
    writes, under multi-host every process (``parallel.mesh.writes``), and
    every rank waits at a barrier until the files are in place, so that no
    rank of a later ``--resume`` reads a half-written one; every rank
    restores."""

    def __init__(self, directory: str, every: int = 0):
        self.dir = directory
        self.every = int(every)

    @property
    def enabled(self) -> bool:
        return self.every > 0

    def _meta_path(self) -> str:
        return os.path.join(self.dir, "meta.json")

    def _net_path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.pt")

    def exists(self) -> bool:
        return os.path.exists(self._meta_path())

    def due(self, epoch: int) -> bool:
        """True when ``maybe_save`` after ``epoch`` will write."""
        return self.enabled and (epoch + 1) % self.every == 0

    def maybe_save(self, phase: str, epoch: int,
                   **nets: Tuple[torch.nn.Module, torch.optim.Optimizer]) -> bool:
        """Save after ``epoch`` when it hits the cadence; True if it saved."""
        if not self.due(epoch):
            return False
        if mesh.writes():
            os.makedirs(self.dir, exist_ok=True)
            for name, (module, opt) in nets.items():
                _save_atomic({"state_dict": module.state_dict(),
                              "optimizer": optim.state_dict(opt)}, self._net_path(name))
            tmp = self._meta_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"phase": phase, "epoch": epoch}, f)
            os.replace(tmp, self._meta_path())
        mesh.barrier()
        return True

    def restore(self, nets: Dict[str, Tuple[torch.nn.Module, torch.optim.Optimizer]]
                ) -> Dict:
        """Load each saved net's state into ``nets`` (a net without a file
        keeps its state, as the JAX templates do) and return the meta record."""
        with open(self._meta_path()) as f:
            meta = json.load(f)
        for name, (module, opt) in nets.items():
            path = self._net_path(name)
            if os.path.exists(path):
                saved = torch.load(path, map_location="cpu", weights_only=True)
                module.load_state_dict(saved["state_dict"], strict=True)
                opt.load_state_dict(saved["optimizer"])
        return meta

    @staticmethod
    def start_epochs(meta: Optional[dict], phase_order: Sequence[str]) -> Dict[str, int]:
        """Per-phase start epochs of a meta record: the phases before the
        recorded one are complete (a start past any epoch count), the
        recorded phase resumes at ``epoch + 1``, later phases start at 0."""
        starts = {p: 0 for p in phase_order}
        if not meta:
            return starts
        seen = False
        for p in phase_order:
            if p == meta["phase"]:
                starts[p] = meta["epoch"] + 1
                seen = True
            elif not seen:
                starts[p] = 10**9
        return starts


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
                   bilinear: bool = True, siamese_stats: str = "joint") -> Segmentor:
    """Eval-mode Segmentor on ``device`` with the weights of the ``.pkl``
    state_dict at ``path``, loaded strictly. The band count comes from the
    first conv's weight; ``siamese_stats`` matters only in train mode."""
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
                    compute_dtype=compute_dtype, siamese_stats=siamese_stats)
    net.load_state_dict(sd, strict=True)
    return net.to(device).eval()
