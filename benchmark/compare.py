"""The numbers that decide ``correct``.

Training (three steps from the same weights and rows); a cell's
``limits`` name the ones it compares. Each leaf number is taken per leaf
as the norm of the difference between the program's tensor and the
reference's, so that it sees direction as well as size, over the larger
of the reference's norm of that leaf and of the median leaf; the median
leaf's value is the number, in every training cell:

* ``grad_gap``: of the first gradient, as the program's optimizer holds it
  after one step (Adam's ``exp_avg`` / (1 - b1); RMSprop's
  sqrt(``square_avg`` / (1 - alpha)) with the sign of the step it took).
* ``change_gap``: of each leaf's change over the three steps.
* ``loss_gap``: the largest relative gap of a step's own reported loss
  (NetLoss; d_loss and s_loss) from the reference's, over the steps.

A leaf whose reference gradient norm is under a thousandth of the median
leaf's (the bias of a conv that a train-mode BatchNorm follows: the batch
mean cancels it) moves by round-off alone and is left out. The worst leaf
of each leaf number, the MS-SSIM metric's gap and the leaves read off
most go to ``detail`` for the reader, and decide nothing.

Serving: ``density_gap``, the largest absolute gap of a served density
pixel from the reference's.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

ADAM_B1 = 0.9
RMS_ALPHA = 0.99
NEGLIGIBLE = 1e-3  # of the median leaf's reference gradient
SSIM = "ssim_loss"  # the MS-SSIM metric every step reports

Leaves = Dict[str, torch.Tensor]


def optimizer_grads(net: torch.nn.Module, opt: torch.optim.Optimizer, prefix: str,
                    start: Leaves) -> Leaves:
    """Each leaf's first gradient, on the host in float64, from a torch Adam
    or RMSprop state after one step; ``start`` holds the leaves before that
    step (RMSprop's state keeps g^2 only, and its step -lr g / |g| the
    sign). Zeros where the optimizer holds nothing for the leaf."""
    out = {}
    for name, p in net.named_parameters():
        key, st = f"{prefix}.{name}", opt.state.get(p, {})
        if "exp_avg" in st:
            g = st["exp_avg"].detach().double().cpu() / (1 - ADAM_B1)
        elif "square_avg" in st:
            size = (st["square_avg"].detach().double().cpu() / (1 - RMS_ALPHA)).sqrt()
            g = size * torch.sign(start[key].double() - p.detach().double().cpu())
        else:
            g = torch.zeros(p.shape, dtype=torch.float64)
        out[key] = g
    return out


def _finite(values: Iterable[float]) -> List[float]:
    values = list(values)
    return values if all(math.isfinite(v) for v in values) else [float("inf")]


def _worst(values: Iterable[float]) -> float:
    """The largest value; infinite when any is not finite."""
    return max(_finite(values))


def _median(values: Iterable[float]) -> float:
    """The median; infinite when any value is not finite."""
    return statistics.median(_finite(values))


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def kept_leaves(ref_grads: Leaves) -> List[str]:
    norms = {k: _norm(v) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= NEGLIGIBLE * med]


def leaf_gaps(prog: Leaves, ref: Leaves, keep: Iterable[str]) -> Dict[str, float]:
    """Each kept leaf's norm of (program - reference) over the larger of its
    reference norm and the median kept leaf's."""
    keep = list(keep)
    norms = {k: _norm(ref[k]) for k in keep}
    med = statistics.median(norms.values())
    return {k: _norm(prog[k].double() - ref[k].double()) / max(norms[k], med, 1e-30)
            for k in keep}


def _top(gaps: Dict[str, float], ref: Leaves, n: int = 4):
    """The leaves read off most: [leaf, gap, reference norm]."""
    return [[k, gaps[k], _norm(ref[k])] for k in sorted(gaps, key=lambda k: -gaps[k])[:n]]


def changes(after: Leaves, before: Leaves) -> Leaves:
    return {k: after[k].double() - before[k].double() for k in after}


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]], keys) -> float:
    return _worst(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
                  for p, r in zip(prog, ref) for k in keys)


def training_checks(prog_losses, prog_grads: Leaves, prog_change: Leaves, ref: Dict,
                    init_params: Leaves, detail: Optional[Dict] = None) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` (the cell's ``limits``
    pick those compared); ``detail``, when given, gets each step's losses,
    the MS-SSIM gap, and each leaf number's worst leaf and top leaves."""
    keep = kept_leaves(ref["grads"])
    ref_change = changes(ref["params"], init_params)
    grad = leaf_gaps(prog_grads, ref["grads"], keep)
    change = leaf_gaps(prog_change, ref_change, keep)
    if detail is not None:
        detail["losses"] = [{k: [p[k], r[k]] for k in r}
                            for p, r in zip(prog_losses, ref["losses"])]
        detail["ssim_gap"] = loss_gap(prog_losses, ref["losses"], [SSIM])
        detail["grad_worst_leaf"] = _worst(grad.values())
        detail["change_worst_leaf"] = _worst(change.values())
        detail["grad"] = _top(grad, ref["grads"])
        detail["change"] = _top(change, ref_change)
        detail["kept_leaves"] = [len(keep), len(ref["grads"])]
    losses = [k for k in ref["losses"][0] if k != SSIM]
    return {"loss_gap": loss_gap(prog_losses, ref["losses"], losses),
            "grad_gap": _median(grad.values()), "change_gap": _median(change.values())}


def density_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return float("inf")
    d = np.abs(prog.astype(np.float64) - ref.astype(np.float64))
    return float(d.max()) if np.isfinite(d).all() else float("inf")
