"""The numbers that decide ``correct`` where the reference follows the
program's state: each of the program's first steps is run again by the
float32 reference from the state the program held before it (parameters,
BatchNorm buffers, optimizer state), on the same rows and learning rates,
and the two steps are compared, each the worst of the steps:

* ``grad_gap``: the gradients the step left in ``.grad``, by
  ``compare.leaf_gaps`` over the kept leaves (``compare.kept_leaves``), the
  median leaf.
* ``loss_gap``: the largest relative gap of a step's losses (WSSS: d_loss
  and s_loss).
* ``wchange_gap``: each kept leaf's change weighted by the size of its
  reference gradient, sum |g_ref| |dp_prog - dp_ref| / sum |g_ref| |dp_ref|,
  the median leaf. RMSprop's first step is lr g / sqrt((1 - alpha) g^2),
  about 10 lr sign(g) whatever the size of g, so an unweighted change
  counts in full every sign flip of an element whose gradient is within
  rounding of zero; weighted, such an element counts by its size. A state
  left unchanged reads 1.
* ``<net>_descent_gap`` (``s_descent_gap``, ``d_descent_gap``): for each
  stepped net, the first-order change of the loss that the program's step
  makes under the reference's gradient, against the reference step's, over
  the net's kept leaves: |sum g_ref (dp_prog - dp_ref)| / |sum g_ref dp_ref|.
  A state left unchanged reads 1, a step half as long 0.5. Rounding moves
  single elements either way and largely cancels in the sum; a step that
  descends less, or elsewhere, does not. D's gradient is the difference of
  its gradients on the changed and the unchanged pairs, so its small
  elements are mostly rounding, and its weighted change gap reads several
  times S's on sound steps; its descent does not.

The worst leaf of each leaf number and the leaves read off most go to
``detail`` and decide nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from . import compare

Leaves = Dict[str, torch.Tensor]


def wchange_gaps(prog: Leaves, ref: Leaves, ref_grads: Leaves, keep: Sequence[str]
                 ) -> Dict[str, float]:
    """Each kept leaf's |g_ref|-weighted gap of the program's change from the
    reference's, over the reference's weighted change."""
    out = {}
    for k in keep:
        g = ref_grads[k].double().abs()
        r = ref[k].double()
        num = float((g * (prog[k].double() - r).abs()).sum())
        den = float((g * r.abs()).sum())
        out[k] = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
    return out


def descent_gaps(prog: Leaves, ref: Leaves, ref_grads: Leaves, keep: Sequence[str]
                 ) -> Dict[str, float]:
    """``<net>_descent_gap`` of each net, the leaves grouped by the name
    before their first dot."""
    sums: Dict[str, List[float]] = {}
    for k in keep:
        g = ref_grads[k].double()
        s = sums.setdefault(k.split(".", 1)[0].lower() + "_descent_gap", [0.0, 0.0])
        s[0] += float((g * (prog[k].double() - ref[k].double())).sum())
        s[1] += float((g * ref[k].double()).sum())
    return {name: abs(num) / abs(den) if den != 0 else (0.0 if num == 0 else float("inf"))
            for name, (num, den) in sorted(sums.items())}


def step_numbers(prog: Dict, ref: Dict, loss_keys: Sequence[str],
                 detail: Optional[Dict] = None) -> Dict[str, float]:
    """One step's ``grad_gap``, ``loss_gap`` and ``wchange_gap``: ``prog`` and
    ``ref`` hold its ``losses`` (a dict), ``grads`` and ``change`` (leaves)."""
    keep = compare.kept_leaves(ref["grads"])
    grad = compare.leaf_gaps(prog["grads"], ref["grads"], keep)
    wchange = wchange_gaps(prog["change"], ref["change"], ref["grads"], keep)
    if detail is not None:
        detail["losses"] = {k: [prog["losses"][k], ref["losses"][k]] for k in loss_keys}
        detail["grad_worst_leaf"] = compare._worst(grad.values())
        detail["wchange_worst_leaf"] = compare._worst(wchange.values())
        detail["grad"] = compare._top(grad, ref["grads"])
        detail["wchange"] = compare._top(wchange, ref["change"])
        detail["kept_leaves"] = [len(keep), len(ref["grads"])]
    return {"grad_gap": compare._median(grad.values()),
            "loss_gap": compare.loss_gap([prog["losses"]], [ref["losses"]], loss_keys),
            "wchange_gap": compare._median(wchange.values()),
            **descent_gaps(prog["change"], ref["change"], ref["grads"], keep)}


def worst_of_steps(prog_steps: List[Dict], ref_steps: List[Dict], loss_keys: Sequence[str],
                   detail: Optional[Dict] = None) -> Dict[str, float]:
    """Each number's worst step; ``detail``, when given, gets each step's
    numbers and details under ``steps``."""
    per = []
    for p, r in zip(prog_steps, ref_steps):
        d = {} if detail is not None else None
        per.append((step_numbers(p, r, loss_keys, d), d))
    if detail is not None:
        detail["steps"] = [dict(d, numbers=n) for n, d in per]
    return {k: compare._worst(n[k] for n, _ in per) for k in per[0][0]}


def unchanged(prog_steps: List[Dict]) -> List[Dict]:
    """The fault of a step that leaves the state unchanged: no change."""
    return [dict(p, change={k: torch.zeros_like(v) for k, v in p["change"].items()})
            for p in prog_steps]
