"""Train and inference steps of the unsupervised, weakly supervised and
regional supervised modes (JAX ``train/steps.py``).

``USSSSteps`` holds the Generator, the Segmentor, their optimizers and the
loss configuration, and runs one batch of each reference phase
(Demo_USSS.py:124-400) plus inference (:404-473). ``WSSSSteps`` does the
same for the G pretrain (Demo_WSSS.py:140-204) and the adversarial S/D
step (:235-343); its final train-mode-BN inference (:387-445) is
``eval.inference.slice_inference``. ``RSSSSteps``
for the G pretrain (Demo_RSSS.py:173-238), the adversarial step with a
region-synthesized unchanged pair (:244-397), the per-epoch test
evaluation (:399-447) and the final inference. Batches are NHWC float32
tensors on the models' device, as in the JAX package; the models see their
NCHW channels_last views. A step returns its metrics as device tensors (the
confusion matrix included), so the epoch loop reads them once per epoch.

Gradient flow, as in the JAX package:
  * G pretrain (:182-198): cmap is zero and the target is data, so the
    perception target branch runs forward only (``target_grad=False``).
  * S init (:200-224): G runs in train mode under ``no_grad``, which
    updates its BatchNorm running statistics without stepping it.
  * Joint (:226-253): the reference zeroes G's gradients before both of its
    backwards and S's between them, so gradG = d(A + NetLoss)/dG and
    gradS = d(NetLoss)/dS, with A = gen + pw*perc + sw*ssim and
    NetLoss = A + l1w*l1. l1 has no G dependence, so ONE forward and ONE
    backward of NetLoss give gradS and dA/dG; G's gradients are then
    doubled. Then both Adam updates run. The joint step is the span
    ``step``, its phases ``step.forward``, ``step.loss``, ``step.backward``
    and ``step.optimizer`` (``utils.timing``).

The USSS joint step and the WSSS adversarial step on a card are CUDA
graphs (``StepGraphs``), one per shape of the step's batch, all of a step's
in one memory pool: dispatching a step eagerly takes the host longer than
the device takes to run it (thousands of small launches: the train-mode
BatchNorms, the VGG passes, the MS-SSIM levels, the optimizers). A shape's
first call is an eager step on the stream the graph is captured on, which
warms cuDNN, cuBLAS, the ticket counters and the optimizers' state; the
same call then captures the step without running it. Every later call of
that shape copies the batch into the graph's static inputs and replays it.
The learning rates are not in the graph: the first graphed call makes the
step's optimizers (the two Adams of USSS, S's and D's RMSprops of WSSS)
capturable, with a tensor rate that ``set_lr`` fills
(``train.optim.make_capturable``). The WSSS graph holds both of its
optimizer steps, D's ahead of S's loss, as the eager step runs them. The
metrics come back cloned, so a caller may keep them; after a replay
``.grad`` holds that graph's gradients and the optimizers' moments are
their own tensors, as after an eager step. The recorder counts
``step.eager``, ``step.graph_captures`` and ``step.graph_replays``. The
phase spans, the other counters and the kernel wrappers' ``launches`` count
on the host, in eager steps and during a capture; a replay adds none of
them (its kernels show only on the device's trace). A step stays eager
where it can see that a graph would not do (``eager_because``): off CUDA,
under a process group (``mesh.active()``), with ``remat``, with an
optimizer whose step cannot be captured (the ``flat`` and ``grouped``
layouts), and under autograd anomaly detection (``--debug-nans``). The G
pretrains, the S init and the RSSS steps stay eager.

``remat=True`` recomputes the forwards that the JAX steps wrap in
``jax.checkpoint`` (steps.py:139-150, 285-301, 491-504) in the backward:
the G and S forwards of USSS, the G forward of the WSSS and RSSS G
pretrains, and every VGG loss stack (``torch.utils.checkpoint``,
non-reentrant). The recompute runs under ``frozen_running_stats``, so each
BatchNorm still updates its running statistics once per forward, as the
pure JAX functions do.

Under a process group (``parallel.mesh``) each rank runs the step on its
slice of the global batch, and the step's result does not depend on how
many ranks computed it, as under the JAX mesh: the BatchNorm statistics
and the loss weight sums are global (``ops/fused_bn``, ``ops/losses``),
the gradients are summed over the ranks in buckets before each optimizer
step (``_apply``), and the metrics a step returns are the global ones,
the per-rank partial sums all-reduced (``_reported``; the confusion
matrix by ``confusion_update``). No ``DistributedDataParallel``: it would
average the gradients, broadcast the BN buffers from rank 0 at every
forward, and its once-per-forward hooks do not fit the steps that run a
net twice per backward, recompute forwards, or run a frozen net.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..eval.evaluator import confusion_update
from ..models.layers import frozen_running_stats
from ..models.vgg import VGG16Weights
from ..ops import losses as L
from ..parallel import mesh
from ..utils.timing import count, span
from .optim import capturable, make_capturable, set_lr


@dataclasses.dataclass(frozen=True)
class PerceptionConfig:
    feature_layers: Tuple[int, ...]
    per_band: bool
    dtype: Optional[torch.dtype] = None  # bfloat16 under mixed precision


def interior_valid_mask(item: torch.Tensor, interior_sizes: torch.Tensor,
                        canvas_hw: Tuple[int, int], pad: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) {0, 1} float mask of each tile's stitched interior, built on
    the device from the per-item core sizes (steps.py:57-76)."""
    h, w = canvas_hw
    padx, pady = pad
    sizes = interior_sizes[item]  # (B, 2) = (core_h, core_w)
    rows = torch.arange(h, device=item.device).view(1, h, 1)
    cols = torch.arange(w, device=item.device).view(1, 1, w)
    ch = sizes[:, 0].view(-1, 1, 1)
    cw = sizes[:, 1].view(-1, 1, 1)
    return ((rows >= pady) & (rows < pady + ch)
            & (cols >= padx) & (cols < padx + cw)).to(torch.float32)


def rematerialized(fn: Callable, *modules: torch.nn.Module) -> Callable:
    """``fn`` whose activations are recomputed in the backward rather than
    kept (``jax.checkpoint``); the recompute leaves the running statistics of
    the BatchNorms in ``modules`` as the forward left them."""
    def contexts():
        return contextlib.nullcontext(), frozen_running_stats(*modules)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts,
                          preserve_rng_state=False)
    return run


def _as_is(fn: Callable, *modules: torch.nn.Module) -> Callable:
    """``fn`` itself: the steps' forwards without ``remat``."""
    return fn


def _params(*opts: torch.optim.Optimizer):
    return [p for opt in opts for group in opt.param_groups for p in group["params"]]


def _step(*opts: torch.optim.Optimizer) -> None:
    """The gradients of the optimizers' parameters summed over the ranks
    (one bucketed all-reduce for all of them), then each step taken."""
    mesh.all_reduce_grads(_params(*opts))
    for opt in opts:
        opt.step()


def _apply(*updates) -> None:
    """Each ``(optimizer, lr)``: its rate set, then ``_step`` of them all."""
    for opt, lr in updates:
        set_lr(opt, lr)
    _step(*(opt for opt, _ in updates))


def _eager_because(device: torch.device, remat: bool, *opts: torch.optim.Optimizer
                   ) -> Optional[str]:
    """Why a step on ``device`` that steps ``opts`` runs eagerly; None when
    it runs as a CUDA graph."""
    if device.type != "cuda":
        return "not a CUDA device"
    if mesh.active():
        return "a process group"
    if remat:
        return "remat"
    if torch.is_anomaly_enabled():
        return "anomaly detection"
    if not all(capturable(opt) for opt in opts):
        return "an optimizer step that cannot be captured"
    return None


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]  # the static inputs
    outputs: Dict[str, torch.Tensor]
    grads: list  # each parameter's gradient as the graph writes it (or None)


def _out_of_memory(e: Optional[BaseException]) -> bool:
    """Whether ``e``, or an exception it was raised while handling, says the
    device ran out of memory: an allocation that fails inside a capture
    surfaces as the CUDA error of ``capture_end``."""
    while e is not None:
        if isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e):
            return True
        e = e.__cause__ or e.__context__
    return False


class StepGraphs:
    """A training step with its optimizer steps, ``body(*inputs)`` returning
    its metrics, as one CUDA graph per shape of ``inputs``, all in one memory
    pool; ``params`` are the parameters the step gives gradients. The body
    comes with each call, so the graphs hold no reference to its owner and
    go, pool and all, when the owner does.

    A shape's first call runs ``body`` eagerly on the capture stream, then
    captures it there without running it: the static inputs are copies of
    the call's inputs, the gradients are set to None so that the captured
    backward writes them fresh from the pool, and the call leaves ``.grad``
    as its eager step left it. A later call of the shape copies its inputs
    into the static ones and replays; the metrics come back cloned, and
    ``.grad`` is pointed at that graph's gradients.

    What the body counts on the host (its spans, the recorder's counters,
    each kernel wrapper's ``launches``) it counts in the eager step and again
    in the capture, which records each launch into the graph; a replay runs
    on the device alone and counts only ``step.graph_replays``. A capture
    that runs out of device memory raises ``torch.cuda.OutOfMemoryError``
    once it is torn down, and leaves the shape uncaptured."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params = list(params)
        self.graphs: Dict[Tuple, _Captured] = {}
        self.stream = None
        self.pool = None
        self.live: Optional[_Captured] = None  # the graph whose gradients .grad holds

    def __call__(self, body: Callable[..., Dict[str, torch.Tensor]], *inputs: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)
        g = self.graphs.get(key)
        if g is None:
            return self._first(body, key, inputs)
        count("step.graph_replays")
        for static, t in zip(g.inputs, inputs):
            static.copy_(t)
        g.graph.replay()
        if self.live is not g:
            for p, grad in zip(self.params, g.grads):
                p.grad = grad
            self.live = g
        return {k: v.clone() for k, v in g.outputs.items()}

    def _first(self, body, key, inputs) -> Dict[str, torch.Tensor]:
        count("step.eager")
        dev = inputs[0].device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        here = torch.cuda.current_stream(dev)
        self.stream.wait_stream(here)
        torch.cuda.empty_cache()  # blocks cached for other streams cannot serve this one
        try:
            with torch.cuda.stream(self.stream):
                out = body(*inputs)
                self.graphs[key] = self._capture(body, inputs)
        finally:
            here.wait_stream(self.stream)
        return out

    def _capture(self, body, inputs) -> _Captured:
        count("step.graph_captures")
        static = tuple(t.clone() for t in inputs)
        eager_grads = [p.grad for p in self.params]
        for p in self.params:
            p.grad = None
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = body(*static)
            grads = [p.grad for p in self.params]
        except Exception as e:
            if not _out_of_memory(e):
                raise
            del graph
            torch.cuda.empty_cache()
            raise torch.cuda.OutOfMemoryError(
                f"out of memory while capturing a step in a CUDA graph: {e}") from e
        finally:
            for p, grad in zip(self.params, eager_grads):
                p.grad = grad
        self.pool = graph.pool()
        self.live = None
        return _Captured(graph, static, outputs, grads)


def _reported(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's metrics for the global batch: every loss summed over the
    ranks in one all-reduce (each rank holds its partial sum)."""
    if not mesh.active():
        return metrics
    keys = [k for k in metrics if k != "confusion"]
    total = mesh.all_reduce_sum(torch.stack([metrics[k].float() for k in keys]))[0]
    return {**metrics, **{k: total[i] for i, k in enumerate(keys)}}


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class USSSSteps:
    def __init__(self, generator, segmentor, opt_g, opt_s, vgg: VGG16Weights,
                 perception: PerceptionConfig, perception_weight: float,
                 l1_weight: float, ssim_weight: float, interior_sizes: np.ndarray,
                 pad: Tuple[int, int], gt_map: Sequence[int] = (1, 2),
                 pre_map: Sequence[int] = (0, 1), prob_thresh: float = 0.5,
                 msssim_weights: Optional[Sequence[float]] = None,
                 ssim_metric: bool = True, remat: bool = False):
        if not ssim_metric and ssim_weight != 0:
            raise ValueError("ssim_metric=False requires ssim_weight == 0")
        self.G, self.S = generator, segmentor
        self.remat = remat
        # a function, not a closure over self: the steps hold no reference
        # cycle, so the joint graphs' pool goes as soon as they do
        self._ck = rematerialized if remat else _as_is
        self.opt_g, self.opt_s = opt_g, opt_s
        self._joint_graphs = StepGraphs(_params(opt_g, opt_s))
        self.vgg = vgg
        self.pc = perception
        self.pw, self.l1w, self.sw = perception_weight, l1_weight, ssim_weight
        self.interior = torch.as_tensor(np.asarray(interior_sizes, np.int64),
                                        device=vgg.device)
        self.pad = tuple(pad)
        self.gt_map, self.pre_map = tuple(gt_map), tuple(pre_map)
        self.prob_thresh = prob_thresh
        self.msw = tuple(msssim_weights) if msssim_weights is not None else None
        self.ssim_metric = ssim_metric

    def _g_fwd(self, x):
        return self._ck(lambda x: _nhwc(self.G(_nchw(x))), self.G)(x)

    def _s_fwd(self, x, y):
        return self._ck(lambda x, y: _nhwc(self.S(_nchw(x), _nchw(y))), self.S)(x, y)

    def _cnet_ck(self, *args):
        return self._ck(self._cnet)(*args)

    def _cnet_ck_pre(self, *args):
        return self._ck(lambda *a: self._cnet(*a, target_grad=False))(*args)

    def _cnet(self, y, y_fake, cmap, w, target_grad=True):
        return L.cnet_loss(
            y, y_fake, cmap, self.vgg, self.pc.feature_layers,
            perception_per_band=self.pc.per_band, msssim_weights=self.msw,
            sample_weight=w, ssim_grad=self.sw != 0, perception_dtype=self.pc.dtype,
            perception_target_grad=target_grad, compute_ssim=self.ssim_metric)

    def _confusion(self, cmap, ref, item, w):
        """Interior-only confusion of the thresholded map (strict ``>``,
        Demo_USSS.py:430-431), padded samples weighted out."""
        with torch.no_grad():
            cmask = (cmap[..., 0] > self.prob_thresh).to(torch.float32)
            valid = interior_valid_mask(item, self.interior, tuple(cmap.shape[1:3]),
                                        self.pad) * w.view(-1, 1, 1)
            return confusion_update(ref[..., 0], cmask, self.gt_map, self.pre_map, valid)

    @staticmethod
    def _metrics(loss, gen, l1, perc, ssim) -> Dict[str, torch.Tensor]:
        return _reported({"NetLoss": loss.detach(), "generator_loss": gen.detach(),
                          "l1_loss": l1.detach(), "perception_loss": perc.detach(),
                          "ssim_loss": ssim.detach()})

    # -- phase 1: generator pretrain (Demo_USSS.py:124-189) -----------------
    def g_pretrain(self, x, y, w, lr) -> Dict[str, torch.Tensor]:
        self.G.train()
        cmap = torch.zeros(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
        y_fake = self._g_fwd(x)
        gen, l1, perc, ssim = self._cnet_ck_pre(y, y_fake, cmap, w)
        loss = gen + self.pw * perc + self.sw * ssim
        self.opt_g.zero_grad(set_to_none=True)
        loss.backward()
        _apply((self.opt_g, lr))
        return self._metrics(loss, gen, l1, perc, ssim)

    # -- phase 2: segmentor init, G forwarded but not stepped (:192-286) ----
    def s_init(self, x, y, ref, item, w, lr) -> Dict[str, torch.Tensor]:
        self.G.train()
        self.S.train()
        with torch.no_grad():  # train-mode G forward: its BN running stats move
            y_fake = _nhwc(self.G(_nchw(x)))
        cmap = self._s_fwd(x, y)
        gen, l1, perc, ssim = self._cnet_ck(y, y_fake, cmap, w)
        loss = gen + self.l1w * l1 + self.pw * perc + self.sw * ssim
        self.opt_s.zero_grad(set_to_none=True)
        loss.backward()
        _apply((self.opt_s, lr))
        m = self._metrics(loss, gen, l1, perc, ssim)
        m["confusion"] = self._confusion(cmap.detach(), ref, item, w)
        return m

    # -- phase 3: joint alternating with G-gradient accumulation (:289-400) --
    def joint(self, x, y, ref, item, w, lr_g, lr_s) -> Dict[str, torch.Tensor]:
        """One joint step: replayed as a CUDA graph unless ``eager_because``
        names a reason (see the module's docstring)."""
        with span("step"):
            self.G.train()
            self.S.train()
            graphed = self.eager_because(x.device) is None
            if graphed:
                make_capturable(self.opt_g)
                make_capturable(self.opt_s)
            set_lr(self.opt_g, lr_g)
            set_lr(self.opt_s, lr_s)
            if graphed:
                return self._joint_graphs(self._joint, x, y, ref, item, w)
            count("step.eager")
            return self._joint(x, y, ref, item, w)

    def eager_because(self, device: torch.device) -> Optional[str]:
        """Why a joint step on ``device`` runs eagerly; None when it runs as
        a CUDA graph."""
        return _eager_because(device, self.remat, self.opt_g, self.opt_s)

    def _joint(self, x, y, ref, item, w) -> Dict[str, torch.Tensor]:
        """The joint step's body, G and S in train mode and the rates set."""
        with span("step.forward"):
            y_fake = self._g_fwd(x)
            cmap = self._s_fwd(x, y)
        with span("step.loss"):
            gen, l1, perc, ssim = self._cnet_ck(y, y_fake, cmap, w)
            a = gen + self.pw * perc + self.sw * ssim  # == LossG
            net_loss = a + self.l1w * l1
        with span("step.backward"):
            self.opt_g.zero_grad(set_to_none=True)
            self.opt_s.zero_grad(set_to_none=True)
            net_loss.backward()
        with span("step.optimizer"):
            with torch.no_grad():  # dLossG/dG + dNetLoss/dG
                for p in self.G.parameters():
                    if p.grad is not None:
                        p.grad.mul_(2.0)
            _step(self.opt_g, self.opt_s)
        m = self._metrics(net_loss, gen, l1, perc, ssim)
        m["confusion"] = self._confusion(cmap.detach(), ref, item, w)
        return m

    # -- inference (:404-473) -------------------------------------------------
    @torch.no_grad()
    def infer(self, x, y) -> torch.Tensor:
        """Eval-mode change density of NCHW tiles, (B, 1, H, W) float32."""
        self.S.eval()
        return self.S(x, y)


def _wmean(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted batch mean of per-sample values (steps.py:84-86), over the
    global weight sum under a process group."""
    return (v * w).sum() / L.weight_norm(w)


class WSSSSteps:
    """Steps of the weakly supervised mode (JAX ``WSSSSteps``, :265-458).

    Gradient flow, as in the JAX package:
      * G pretrain on unchanged pairs: cmap is zero and the target is data,
        so the perception target branch runs forward only.
      * Adversarial: ONE pair of train-mode S forwards (changed pair, then
        unchanged pair; S's BN statistics move on both, in order) keeps its
        graph. The D update sees the detached masks, the unchanged pair
        masked by the CHANGED pair's mask (:367-373), with loss
        ``1 + wmean(D(nc)) - wmean(D(c))``, then RMSprop. The frozen G runs in
        eval mode under ``no_grad``. The S loss
        ``dw*s_d + l1w*l1 + gw*g + ncw*nc`` re-evaluates the UPDATED D on
        the changed pair masked by the live map; its gradients go into S's
        parameters only (``torch.autograd.grad``), so it never steps D, and
        D's BN statistics move on all three of its forwards.
    Each step leaves each stepped net's gradients in ``.grad``. On a card
    the adversarial step is a CUDA graph per batch shape, with both
    RMSprop steps inside it (see the module's docstring). The step is the
    span ``adv``, its phases ``adv.s_forward`` (both S forwards),
    ``adv.d_update`` (D's two forwards, its backward and RMSprop),
    ``adv.s_loss`` (the frozen G, the D re-evaluation, the cgenerator loss
    and the sums), ``adv.s_backward`` (``autograd.grad`` into S) and
    ``adv.s_optimizer`` (``utils.timing``); the phases are recorded by
    eager steps and captures, a replay records ``adv`` alone."""

    def __init__(self, generator, segmentor, discriminator, opt_g, opt_s, opt_d,
                 vgg: VGG16Weights, perception: PerceptionConfig, perception_weight: float,
                 ssim_weight: float, g_weight: float, l1_weight: float, d_weight: float,
                 nc_weight: float, prob_thresh: float = 0.6,
                 discriminator_continuous: bool = True,
                 msssim_weights: Optional[Sequence[float]] = None, ssim_metric: bool = True,
                 remat: bool = False):
        if not ssim_metric and ssim_weight != 0:
            raise ValueError("ssim_metric=False requires ssim_weight == 0")
        self.G, self.S, self.D = generator, segmentor, discriminator
        self.remat = remat
        # a function, not a closure over self: the steps hold no reference
        # cycle, so the adversarial graphs' pool goes as soon as they do
        self._ck = rematerialized if remat else _as_is
        self.opt_g, self.opt_s, self.opt_d = opt_g, opt_s, opt_d
        self._adv_graphs = StepGraphs(_params(opt_s, opt_d))
        self.vgg = vgg
        self.pc = perception
        self.pw, self.sw = perception_weight, ssim_weight
        self.gw, self.l1w, self.dw, self.ncw = g_weight, l1_weight, d_weight, nc_weight
        self.prob_thresh = prob_thresh
        self.continuous = discriminator_continuous
        self.msw = tuple(msssim_weights) if msssim_weights is not None else None
        self.ssim_metric = ssim_metric

    def _g_fwd(self, x):
        return self._ck(lambda x: _nhwc(self.G(_nchw(x))), self.G)(x)

    def _cgen_ck(self, *args):
        return self._ck(self._cgen)(*args)

    def _cgen_ck_pre(self, *args):
        return self._ck(lambda *a: self._cgen(*a, target_grad=False))(*args)

    def _cgen(self, y, y_fake, cmap, w, target_grad=True):
        return L.cgenerator_loss(
            y, y_fake, cmap, self.vgg, self.pc.feature_layers,
            perception_per_band=self.pc.per_band, msssim_weights=self.msw,
            sample_weight=w, ssim_grad=self.sw != 0, perception_dtype=self.pc.dtype,
            perception_target_grad=target_grad, compute_ssim=self.ssim_metric)

    def _d(self, x, y):
        return self.D(_nchw(x), _nchw(y))

    # -- G pretrain on unchanged pairs, cmap = 0 (Demo_WSSS.py:140-204) -----
    def g_pretrain(self, x, y, w, lr) -> Dict[str, torch.Tensor]:
        self.G.train()
        cmap = torch.zeros(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
        y_fake = self._g_fwd(x)
        gen, ssim, perc = self._cgen_ck_pre(y, y_fake, cmap, w)
        loss = gen + self.pw * perc + self.sw * ssim
        self.opt_g.zero_grad(set_to_none=True)
        loss.backward()
        _apply((self.opt_g, lr))
        return _reported({"g_loss": loss.detach(), "generator_loss": gen.detach(),
                          "perception_loss": perc.detach(), "ssim_loss": ssim.detach()})

    # -- adversarial D-then-S step (Demo_WSSS.py:235-343) -------------------
    def adversarial(self, c_x, c_y, c_ref, nc_x, nc_y, w, lr_s, lr_d
                    ) -> Dict[str, torch.Tensor]:
        """One adversarial step: replayed as a CUDA graph unless
        ``eager_because`` names a reason (see the module's docstring)."""
        with span("adv"):
            self.G.eval()
            self.S.train()
            self.D.train()
            graphed = self.eager_because(c_x.device) is None
            if graphed:
                make_capturable(self.opt_s)
                make_capturable(self.opt_d)
            set_lr(self.opt_s, lr_s)
            set_lr(self.opt_d, lr_d)
            if graphed:
                return self._adv_graphs(self._adversarial, c_x, c_y, c_ref, nc_x, nc_y, w)
            count("step.eager")
            return self._adversarial(c_x, c_y, c_ref, nc_x, nc_y, w)

    def eager_because(self, device: torch.device) -> Optional[str]:
        """Why an adversarial step on ``device`` runs eagerly; None when it
        runs as a CUDA graph."""
        return _eager_because(device, self.remat, self.opt_s, self.opt_d)

    def _adversarial(self, c_x, c_y, c_ref, nc_x, nc_y, w) -> Dict[str, torch.Tensor]:
        """The adversarial step's body, G, S and D in their modes and both
        rates set."""
        with span("adv.s_forward"):
            cmap = _nhwc(self.S(_nchw(c_x), _nchw(c_y)))
            ncmap = _nhwc(self.S(_nchw(nc_x), _nchw(nc_y)))

        # D update: the masks are data, the gradients go into D only
        with span("adv.d_update"):
            cmask = (cmap if self.continuous else L.hard_mask(cmap)).detach()
            keep = 1 - cmask
            c_out = self._d(c_x * keep, c_y * keep)  # D's BN statistics: c, then nc
            nc_out = self._d(nc_x * keep, nc_y * keep)
            d_loss = mesh.lead_share(1.0) + _wmean(nc_out, w) - _wmean(c_out, w)
            self.opt_d.zero_grad(set_to_none=True)
            d_loss.backward()
            _step(self.opt_d)

        with span("adv.s_loss"):
            # the frozen G (eval mode, Demo_WSSS.py:206)
            y_fake = None
            if self.gw != 0:
                with torch.no_grad():
                    y_fake = _nhwc(self.G(_nchw(c_x)))

            # S loss against the updated D
            keep = 1 - (cmap if self.continuous else L.hard_mask(cmap))
            s_d_loss = _wmean(self._d(c_x * keep, c_y * keep), w)
            nc_loss = _wmean(ncmap.square().mean(dim=(1, 2, 3)), w)
            if y_fake is not None:
                gen, ssim, perc = self._cgen_ck(c_y, y_fake, cmap, w)
            else:
                gen = ssim = perc = torch.zeros((), dtype=c_x.dtype, device=c_x.device)
            g_loss = gen + self.pw * perc + self.sw * ssim
            l1_loss = _wmean(cmap.abs().mean(dim=(1, 2, 3)), w)
            s_loss = (self.dw * s_d_loss + self.l1w * l1_loss + self.gw * g_loss
                      + self.ncw * nc_loss)
        with span("adv.s_backward"):
            params = [p for p in self.S.parameters() if p.requires_grad]
            grads = torch.autograd.grad(s_loss, params, allow_unused=True)
        with span("adv.s_optimizer"):
            self.opt_s.zero_grad(set_to_none=True)
            for p, g in zip(params, grads):
                p.grad = g
            _step(self.opt_s)

        # in-training eval on the changed pair, full patch (Demo_WSSS.py:337-343)
        with torch.no_grad():
            cmask_t = (cmap[..., 0] > self.prob_thresh).to(torch.float32)
            valid = w.view(-1, 1, 1).expand_as(cmask_t)
            cm = confusion_update(c_ref[..., 0], cmask_t, (0, 1), (0, 1), valid)
        return _reported({"d_loss": d_loss.detach(), "s_loss": s_loss.detach(),
                          "s_d_loss": s_d_loss.detach(), "l1_loss": l1_loss.detach(),
                          "nc_loss": nc_loss.detach(), "g_loss": g_loss.detach(),
                          "generator_loss": gen.detach(), "ssim_loss": ssim.detach(),
                          "perception_loss": perc.detach(), "confusion": cm})


class RSSSSteps:
    """Steps of the regional supervised mode (JAX ``RSSSSteps``, :466-662).

    Gradient flow, as in the JAX package:
      * G pretrain with the REGION raster as the mask (Demo_RSSS.py:200-205):
        the mask and the target are data, so the perception target branch
        runs forward only.
      * Adversarial: ONE train-mode S forward keeps its graph. The D update
        sees the detached mask, on the pair (x, y) and on the unchanged pair
        synthesized from the region, (x, y*(1-region) + x*region), both
        masked by the same ``1 - cmask`` (:296-301), with loss
        ``1 + wmean(D(nc)) - wmean(D(c))``, then RMSprop. The frozen G runs
        in eval mode under ``no_grad``. The S loss ``dw*s_d + l1w*l1 + gw*g +
        rw*r``, with ``l1 = region_loss(cmap, region, l1)`` and ``r =
        region_loss(cmap, 1 - region, mse)``, re-evaluates the UPDATED D on
        the pair masked by the live map; its gradients go into S's
        parameters only, so D's BN statistics move on all three of its
        forwards and D is stepped once.
      * The per-epoch test evaluation thresholds the map over each tile's
        interior (``test_interior_sizes``): in eval mode
        (``eval_confusion``), or in train mode under ``no_grad``
        (``eval_confusion_train``, reference parity: the test batches move
        S's BN running statistics, Demo_RSSS.py:415).
    Each training step leaves each stepped net's gradients in ``.grad``."""

    def __init__(self, generator, segmentor, discriminator, opt_g, opt_s, opt_d,
                 vgg: VGG16Weights, perception: PerceptionConfig, perception_weight: float,
                 ssim_weight: float, g_weight: float, l1_weight: float, d_weight: float,
                 r_weight: float, interior_sizes: np.ndarray, pad: Tuple[int, int],
                 gt_map: Sequence[int] = (1, 2), pre_map: Sequence[int] = (0, 1),
                 prob_thresh: float = 0.5, discriminator_continuous: bool = True,
                 msssim_weights: Optional[Sequence[float]] = None,
                 test_interior_sizes: Optional[np.ndarray] = None, ssim_metric: bool = True,
                 remat: bool = False):
        if not ssim_metric and ssim_weight != 0:
            raise ValueError("ssim_metric=False requires ssim_weight == 0")
        self.G, self.S, self.D = generator, segmentor, discriminator
        ck = rematerialized if remat else (lambda fn, *modules: fn)
        self._g_fwd = ck(lambda x: _nhwc(self.G(_nchw(x))), self.G)
        self._cgen_ck = ck(self._cgen)
        self._cgen_ck_pre = ck(lambda *a: self._cgen(*a, target_grad=False))
        self.opt_g, self.opt_s, self.opt_d = opt_g, opt_s, opt_d
        self.vgg = vgg
        self.pc = perception
        self.pw, self.sw = perception_weight, ssim_weight
        self.gw, self.l1w, self.dw, self.rw = g_weight, l1_weight, d_weight, r_weight

        def sizes(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=vgg.device)

        self.interior = sizes(interior_sizes)
        self.test_interior = (self.interior if test_interior_sizes is None
                              else sizes(test_interior_sizes))
        self.pad = tuple(pad)
        self.gt_map, self.pre_map = tuple(gt_map), tuple(pre_map)
        self.prob_thresh = prob_thresh
        self.continuous = discriminator_continuous
        self.msw = tuple(msssim_weights) if msssim_weights is not None else None
        self.ssim_metric = ssim_metric

    def _cgen(self, y, y_fake, cmap, w, target_grad=True):
        return L.cgenerator_loss(
            y, y_fake, cmap, self.vgg, self.pc.feature_layers,
            perception_per_band=self.pc.per_band, msssim_weights=self.msw,
            sample_weight=w, ssim_grad=self.sw != 0, perception_dtype=self.pc.dtype,
            perception_target_grad=target_grad, compute_ssim=self.ssim_metric)

    def _d(self, x, y):
        return self.D(_nchw(x), _nchw(y))

    def _s(self, x, y):
        return _nhwc(self.S(_nchw(x), _nchw(y)))

    def _confusion(self, cmap, ref, item, w, interior):
        """Interior-only confusion of the thresholded map (strict ``>``),
        padded samples weighted out (steps.py:638-643)."""
        with torch.no_grad():
            cmask = (cmap[..., 0] > self.prob_thresh).to(torch.float32)
            valid = interior_valid_mask(item, interior, tuple(cmap.shape[1:3]),
                                        self.pad) * w.view(-1, 1, 1)
            return confusion_update(ref[..., 0], cmask, self.gt_map, self.pre_map, valid)

    # -- G pretrain with the region raster as mask (Demo_RSSS.py:173-238) ---
    def g_pretrain(self, x, y, region, w, lr) -> Dict[str, torch.Tensor]:
        self.G.train()
        y_fake = self._g_fwd(x)
        gen, ssim, perc = self._cgen_ck_pre(y, y_fake, region, w)
        loss = gen + self.pw * perc + self.sw * ssim
        self.opt_g.zero_grad(set_to_none=True)
        loss.backward()
        _apply((self.opt_g, lr))
        return _reported({"g_loss": loss.detach(), "generator_loss": gen.detach(),
                          "perception_loss": perc.detach(), "ssim_loss": ssim.detach()})

    # -- adversarial D-then-S step with the synthesized pair (:266-397) ------
    def adversarial(self, x, y, ref, region, item, w, lr_s, lr_d
                    ) -> Dict[str, torch.Tensor]:
        self.G.eval()
        self.S.train()
        self.D.train()
        cmap = self._s(x, y)

        # D update: the mask is data, the gradients go into D only
        cmask = (cmap if self.continuous else L.hard_mask(cmap)).detach()
        keep = 1 - cmask
        y_unc = y * (1 - region) + x * region  # inside regions x replaces y
        c_out = self._d(x * keep, y * keep)  # D's BN statistics: c, then nc
        nc_out = self._d(x * keep, y_unc * keep)
        d_loss = mesh.lead_share(1.0) + _wmean(nc_out, w) - _wmean(c_out, w)
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        _apply((self.opt_d, lr_d))

        with torch.no_grad():  # the frozen G, eval mode (Demo_RSSS.py:240)
            y_fake = _nhwc(self.G(_nchw(x)))

        # S loss against the updated D
        keep = 1 - (cmap if self.continuous else L.hard_mask(cmap))
        s_d_loss = _wmean(self._d(x * keep, y * keep), w)
        gen, ssim, perc = self._cgen_ck(y, y_fake, cmap, w)
        g_loss = gen + self.pw * perc + self.sw * ssim
        l1_loss = L.region_loss(cmap, region, "l1", sample_weight=w)
        r_loss = L.region_loss(cmap, 1 - region, "mse", sample_weight=w)
        s_loss = (self.dw * s_d_loss + self.l1w * l1_loss + self.gw * g_loss
                  + self.rw * r_loss)
        params = [p for p in self.S.parameters() if p.requires_grad]
        grads = torch.autograd.grad(s_loss, params, allow_unused=True)
        self.opt_s.zero_grad(set_to_none=True)
        for p, g in zip(params, grads):
            p.grad = g
        _apply((self.opt_s, lr_s))
        return _reported({"d_loss": d_loss.detach(), "s_loss": s_loss.detach(),
                          "s_d_loss": s_d_loss.detach(), "l1_loss": l1_loss.detach(),
                          "r_loss": r_loss.detach(), "g_loss": g_loss.detach(),
                          "generator_loss": gen.detach(), "ssim_loss": ssim.detach(),
                          "perception_loss": perc.detach(),
                          "confusion": self._confusion(cmap.detach(), ref, item, w,
                                                       self.interior)})

    # -- inference and the per-epoch test evaluation (:399-504) --------------
    @torch.no_grad()
    def infer(self, x, y) -> torch.Tensor:
        """Eval-mode change density (B, H, W, 1) f32 of NHWC pairs."""
        self.S.eval()
        return self._s(x, y)

    def eval_confusion(self, x, y, ref, item, w):
        """Eval-mode test confusion over the tiles' interiors, and the map."""
        cmap = self.infer(x, y)
        return self._confusion(cmap, ref, item, w, self.test_interior), cmap

    @torch.no_grad()
    def eval_confusion_train(self, x, y, ref, item, w):
        """The same with S in train mode (reference parity: the reference
        never calls ``netS.eval()`` in its adversarial loop, so its test
        forward, Demo_RSSS.py:415, normalizes with the batch statistics and
        moves S's BN running statistics, which the final eval-mode inference
        then uses)."""
        self.S.train()
        cmap = self._s(x, y)
        return self._confusion(cmap, ref, item, w, self.test_interior), cmap
