"""Adam and RMSprop with the reference's settings, the learning rate set per epoch.

The JAX package builds unit-LR torch-semantics optimizers and multiplies the
update by the epoch's learning rate: Adam with bias correction and eps
outside the square root, betas (0.9, 0.99), eps 1e-8 (Demo_USSS.py:121,
optim.py:193), and RMSprop with alpha 0.99, eps 1e-8 outside the square
root, no momentum, not centered (Demo_WSSS.py:121-122, optim.py:210-249).
The port sets the param group's learning rate once per epoch, which is the
same arithmetic.

A leaf Adam whose parameters are all on a card can be made capturable
(``make_capturable``), so that its step runs inside a CUDA graph (the USSS
joint step, ``train.steps.StepGraphs``, which does it at its first graphed
call) and its rate still moves per epoch: the group turns
``capturable``, its rate becomes a 0-d tensor on the parameters' device
and its step counts move there, as torch keeps them for a capturable Adam.
``set_lr`` fills a tensor rate in place, and only when the value changes,
so setting the same rate every step launches nothing and never waits for
the device. ``build`` makes the plain Adam, with a float rate and
torch's default step, and it stays so until a graph takes it: every Adam
of WSSS and RSSS, the USSS Adams before the first joint step (the G
pretrain, the S init), and every optimizer on the CPU. ``state_dict``
saves a capturable Adam in the plain form, so a checkpoint loads on any
device into the optimizer ``build`` makes; the next graphed step makes it
capturable again.

The layout of the optimizer state is the JAX package's choice
(``_opt_mode``, optim.py:26-52), read from the environment when an
optimizer is built: ``FCDGAN_OPT=leaf|flat|grouped``, or
``FCDGAN_FUSED_OPT=1`` for flat.

  * ``leaf`` (the default): ``torch.optim.Adam`` / ``RMSprop`` with torch's
    default implementation, moments per parameter.
  * ``flat`` (optim.py:59-83, 228-240): ``LayoutOptimizer`` with the moments
    of all the parameters in one flat f32 vector. A step concatenates the
    gradients, updates with a handful of whole-vector elementwise ops and
    adds each parameter's slice of the update to it.
  * ``grouped`` (optim.py:99-190): the parameters of at most
    ``GROUP_SMALL`` elements (BN scales and biases, conv biases, PReLU
    slopes) share one flat vector; the larger ones keep moments per
    parameter, updated with torch's multi-tensor (foreach) ops. The element
    counts of the port's OIHW kernels are those of the JAX HWIO kernels.

Each layout computes torch's update element for element. As in the JAX
layouts, one step count serves a whole param group, and a parameter
without a gradient (the conv biases that a train-mode BN folds away) steps
with a zero gradient where torch's own optimizers skip it; for a parameter
that never has a gradient the two agree: its moments stay zero and it does
not move.
"""

from __future__ import annotations

import math
import os
from typing import Iterable, List, Optional

import torch

BETAS = (0.9, 0.99)
EPS = 1e-8
RMS_ALPHA = 0.99
GROUP_SMALL = 1 << 15  # elements; parameters at or below it share the flat vector
LAYOUTS = ("leaf", "flat", "grouped")


def opt_mode() -> str:
    """The optimizer layout the environment asks for (JAX optim.py:26-52)."""
    mode = os.environ.get("FCDGAN_OPT")
    if mode:
        if mode not in LAYOUTS:
            raise ValueError(f"FCDGAN_OPT must be one of {LAYOUTS}, not {mode!r}")
        return mode
    return "flat" if os.environ.get("FCDGAN_FUSED_OPT") == "1" else "leaf"


class LayoutOptimizer(torch.optim.Optimizer):
    """torch-semantics Adam (``algorithm="adam"``) or RMSprop (``"rmsprop"``)
    whose moments of the parameters of at most ``small_elems`` elements are
    one flat f32 vector per param group (``None``: every parameter, the flat
    layout) and whose larger parameters keep their own.

    The shared state (the step count and the flat moments) lives in the
    state of the group's first parameter, so ``state_dict`` /
    ``load_state_dict`` are torch's own; a state saved by another layout or
    algorithm is refused."""

    def __init__(self, params: Iterable[torch.nn.Parameter], algorithm: str,
                 small_elems: Optional[int] = None):
        if algorithm not in ("adam", "rmsprop"):
            raise ValueError(f"algorithm must be adam or rmsprop, not {algorithm!r}")
        layout = "flat" if small_elems is None else f"grouped<={small_elems}"
        super().__init__(params, dict(lr=0.0, betas=BETAS, alpha=RMS_ALPHA, eps=EPS,
                                      layout=f"{algorithm}:{layout}"))
        self.algorithm = algorithm
        self.small_elems = small_elems

    def _small(self, p: torch.Tensor) -> bool:
        return self.small_elems is None or p.numel() <= self.small_elems

    def load_state_dict(self, state_dict) -> None:
        saved = [g.get("layout") for g in state_dict["param_groups"]]
        mine = [g["layout"] for g in self.param_groups]
        if saved != mine:
            raise ValueError(f"optimizer state of layout {saved} cannot be loaded into "
                             f"{mine} (FCDGAN_OPT must match the run that saved it)")
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LayoutOptimizer takes no closure")
        for group in self.param_groups:
            self._step_group(group)

    def _moments(self, group, small: List[torch.Tensor], big: List[torch.Tensor]) -> dict:
        head = self.state[group["params"][0]]
        names = ("exp_avg", "exp_avg_sq") if self.algorithm == "adam" else ("square_avg",)
        if not head:
            n = sum(p.numel() for p in small)
            dev = group["params"][0].device
            head["step"] = torch.tensor(0.0)
            for k in names:
                head["flat_" + k] = torch.zeros(n, dtype=torch.float32, device=dev)
            for p in big:
                for k in names:
                    self.state[p][k] = torch.zeros_like(p, memory_format=torch.preserve_format)
        head["step"] += 1
        return head

    def _step_group(self, group) -> None:
        params = group["params"]
        small = [p for p in params if self._small(p)]
        big = [p for p in params if not self._small(p)]
        head = self._moments(group, small, big)
        step, lr, eps = float(head["step"]), group["lr"], group["eps"]

        def grads(ps):
            return [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]

        if self.algorithm == "adam":
            b1, b2 = group["betas"]
            step_size = lr / (1 - b1 ** step)
            bc2_sqrt = math.sqrt(1 - b2 ** step)
        if small:
            g = torch.cat([t.reshape(-1).float() for t in grads(small)])
            if self.algorithm == "adam":
                m, v = head["flat_exp_avg"], head["flat_exp_avg_sq"]
                m.lerp_(g, 1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = m / (v.sqrt() / bc2_sqrt).add_(eps)
                scale = -step_size
            else:
                sq = head["flat_square_avg"]
                sq.mul_(group["alpha"]).addcmul_(g, g, value=1 - group["alpha"])
                u = g / sq.sqrt().add_(eps)
                scale = -lr
            parts = u.split([p.numel() for p in small])
            torch._foreach_add_(small, [c.view_as(p).to(p.dtype) for c, p in zip(parts, small)],
                                alpha=scale)
        if not big:
            return
        g_big = grads(big)
        if self.algorithm == "adam":
            m_big = [self.state[p]["exp_avg"] for p in big]
            v_big = [self.state[p]["exp_avg_sq"] for p in big]
            torch._foreach_lerp_(m_big, g_big, 1 - b1)
            torch._foreach_mul_(v_big, b2)
            torch._foreach_addcmul_(v_big, g_big, g_big, value=1 - b2)
            denom = torch._foreach_sqrt(v_big)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(big, m_big, denom, value=-step_size)
        else:
            sq_big = [self.state[p]["square_avg"] for p in big]
            torch._foreach_mul_(sq_big, group["alpha"])
            torch._foreach_addcmul_(sq_big, g_big, g_big, value=1 - group["alpha"])
            avg = torch._foreach_sqrt(sq_big)
            torch._foreach_add_(avg, eps)
            torch._foreach_addcdiv_(big, g_big, avg, value=-lr)


def build(params: Iterable[torch.nn.Parameter], algorithm: str, layout: str
          ) -> torch.optim.Optimizer:
    """``algorithm`` (adam or rmsprop) over ``params`` in ``layout``."""
    if layout == "flat":
        return LayoutOptimizer(params, algorithm)
    if layout == "grouped":
        return LayoutOptimizer(params, algorithm, GROUP_SMALL)
    if layout != "leaf":
        raise ValueError(f"optimizer layout must be one of {LAYOUTS}, not {layout!r}")
    if algorithm == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=BETAS, eps=EPS)
    return torch.optim.RMSprop(params, lr=0.0, alpha=RMS_ALPHA, eps=EPS, momentum=0.0,
                               centered=False)


def adam(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """Adam over ``params`` in the environment's layout (``opt_mode``); its
    learning rate comes from ``set_lr``."""
    return build(params, "adam", opt_mode())


def rmsprop(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """RMSprop over ``params`` in the environment's layout; its learning rate
    comes from ``set_lr``."""
    return build(params, "rmsprop", opt_mode())


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Each param group's rate: a float is assigned; a tensor rate
    (``make_capturable``) is filled in place when ``lr`` differs from the
    value last written (the group's ``lr_value``)."""
    lr = float(lr)
    for group in opt.param_groups:
        rate = group["lr"]
        if not isinstance(rate, torch.Tensor):
            group["lr"] = lr
        elif group.get("lr_value") != lr:
            rate.fill_(lr)
            group["lr_value"] = lr


def capturable(opt: torch.optim.Optimizer) -> bool:
    """Whether ``make_capturable`` can make ``opt``'s step one that a CUDA
    graph holds, once its parameters are on a card: a leaf Adam (torch's
    own, not fused)."""
    return type(opt) is torch.optim.Adam and not any(
        group.get("fused") for group in opt.param_groups)


def make_capturable(opt: torch.optim.Optimizer) -> None:
    """``opt`` (``capturable(opt)``) made capturable in place, where it is
    not yet: each param group ``capturable``, its rate a 0-d tensor on the
    parameters' device holding the rate it had, and the step count of each
    parameter's state moved there. Cheap when nothing is left to do, as
    after the first call; a ``load_state_dict`` undoes it, and the next call
    redoes it."""
    for group in opt.param_groups:
        dev = group["params"][0].device
        rate = group["lr"]
        if (group["capturable"] and isinstance(rate, torch.Tensor)
                and rate.device == dev):
            continue
        value = float(rate)
        group["lr"] = torch.full((), value, dtype=torch.float32, device=dev)
        group["lr_value"] = value
        group["capturable"] = True
        for p in group["params"]:
            step = opt.state.get(p, {}).get("step")
            if step is not None:
                opt.state[p]["step"] = step.to(p.device)


def state_dict(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` in the form of the optimizer ``build`` makes: a
    tensor rate (``make_capturable``) saved as the float it holds, with
    ``capturable`` off, so that the state loads on the CPU as on a card."""
    sd = opt.state_dict()
    for group in sd["param_groups"]:  # the optimizer's own groups are not these
        if isinstance(group["lr"], torch.Tensor):
            value = group.pop("lr_value", None)
            group["lr"] = float(group["lr"]) if value is None else value
            group["capturable"] = False
    return sd
