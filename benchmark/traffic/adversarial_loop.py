"""Traffic driver ``adversarial_loop``: the WSSS adversarial phase of the
driver loop (S against the siamese D, both RMSprop, the frozen G), epoch
after epoch, through the driver's own feed, checked against a reference
that follows the program's state.

Set-up is ``train_loop``'s for a ``wsss`` configuration: the changed and
unchanged slice pairs from the seed written as WHU slices with their label
file, the statistics caches, the pair dataset re-paired each epoch, the
feed ``demos.demo_wsss.slice_feed`` picks (the resident slice stacks), the
networks with weights from the seed, and ``WSSSSteps.adversarial`` at the
step's epoch's ``S_ADV_WSSS`` / ``D_ADV_WSSS`` rates. One warm epoch
(epoch 0) runs every shape. Before its first step and after each of its
first three, the driver takes S's and D's parameters, BatchNorm buffers
and RMSprop state to the host, with the gradients each step left in
``.grad``, its losses and its batch rows. With ``--trace 1`` the first
steps of the next epoch run under the profiler, inside the program's
recorder (``utils.timing.recording``), whose spans go to the window as
host spans and to the record (``program_spans``, ``counters``); the
recorder is off in the timed window. Then the window, as ``train_loop``'s:
whole epochs back to back, each batch loaded, placed, stepped, and each
epoch's averages read once, for ``seconds``; the rate counts both pairs of
every step begun in it.

The check (``compare_steps``): after the window the float32 reference
takes each of the three steps again from the program's state before it
(``reference.from_state``), and ``grad_gap``, ``loss_gap`` and
``wchange_gap`` compare the two, each the worst step.

Parameters: ``profile_steps``. The record also holds what the check used
(``kept``, ``raw``, ``init_g``), from which ``control_steps`` takes its
readings.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import compare_steps, trace, work
from ..reference import from_state
from ..reference import models as ref_models
from .train_loop import NETS, SETUPS, Feed, _items, init_states, raw_data, reference_data

LOSSES = ("d_loss", "s_loss")
KEPT_STEPS = 3


def _state(s: Dict) -> Dict:
    """S's and D's state dicts and RMSprop ``square_avg``s, on the host."""
    out = {"nets": {}, "sq": {}}
    for k, net in s["nets"].items():
        out["nets"][k] = {n: t.detach().cpu().clone() for n, t in net.state_dict().items()}
        opt = s["opt"][k]
        out["sq"][k] = {n: (opt.state[p]["square_avg"].detach().cpu().clone()
                            if "square_avg" in opt.state.get(p, {}) else torch.zeros(p.shape))
                        for n, p in net.named_parameters()}
    return out


def _grads(s: Dict) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": (p.grad.detach().cpu().clone() if p.grad is not None
                         else torch.zeros(p.shape))
            for k, net in s["nets"].items() for n, p in net.named_parameters()}


def _params(state: Dict) -> Dict[str, torch.Tensor]:
    """The parameters (no buffers) of a kept state, by leaf name."""
    return {f"{k}.{n}": state["nets"][k][n] for k in state["sq"] for n in state["sq"][k]}


def program_steps(kept: Dict) -> List[Dict]:
    """The program's kept steps as ``compare_steps`` takes them."""
    out = []
    for i, (losses, grads) in enumerate(zip(kept["losses"], kept["grads"])):
        before, after = _params(kept["states"][i]), _params(kept["states"][i + 1])
        out.append({"losses": losses, "grads": grads,
                    "change": {k: after[k].double() - before[k].double() for k in after}})
    return out


def run(r) -> Dict:
    from fcdgan_tpu_torch.train.loops import EpochAverages
    from fcdgan_tpu_torch.utils import timing

    cfg, dev = r.config, torch.device(r.device)
    if cfg["mode"] != "wsss":
        raise ValueError(f"adversarial_loop runs a wsss configuration, not {cfg['mode']!r}")
    dtype = getattr(torch, cfg["compute_dtype"])
    vgg_params = ref_models.vgg16_params(cfg["vgg_seed"])
    with r.phase("data"):
        init = init_states(cfg, r.seed, dev, NETS["wsss"])
        raw = raw_data(r)
    with r.phase("program"):
        s = SETUPS["wsss"](r, dev, dtype, init, raw, vgg_params)
    feed = Feed(s["loader"])
    state = {"av": EpochAverages(s["total"]), "items": 0, "steps": 0, "flops": 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one():
        """One batch stepped, or an epoch's averages read; the batch rows."""
        with r.timed("feed"):
            b = feed.next()
        if b is None:
            with r.timed("epoch_end"):
                state["av"][s["loss_key"]]
                state["av"].evaluator()
            state["av"] = EpochAverages(s["total"])
            return None
        with r.timed("put"):
            db = s["put"](b)
        with r.timed("dispatch"):
            m = s["step"](db, feed.epoch)
        n = _items(b)
        state["av"].update(m, float(n))
        state["items"] += n
        state["steps"] += 1
        state["flops"] += s["flops"](n)
        state["last"] = m
        return b

    # -- warm epoch; the state around its first three steps is kept ----------
    with r.phase("warm epoch"):
        kept = {"rows": [], "losses": [], "grads": [], "states": [_state(s)]}
        while (b := one()) is not None:
            if len(kept["rows"]) < KEPT_STEPS:
                kept["rows"].append({k: np.array(b[k]) for k in s["rows"]})
                kept["losses"].append({k: float(state["last"][k]) for k in LOSSES})
                kept["grads"].append(_grads(s))
                kept["states"].append(_state(s))
        sync()

    # -- the profiled steps (--trace 1), inside the program's recorder -------
    traced, spans, counters = None, {}, {}
    if r.trace:
        sizes = []
        with trace.Window(dev) as w:
            r.window = w
            one()  # the profiler's warm-up
            w.start()
            with timing.recording() as rec:
                while len(sizes) < r.params["profile_steps"]:
                    b = one()
                    if b is not None:
                        sizes.append(_items(b))
            for sp in rec.spans:
                w.host_span(sp.name, sp.start, sp.end)
                spans.setdefault(sp.name, []).append(sp.end - sp.start)
            counters = dict(rec.counters)
        r.window = None
        traced = w.summary
        traced["units"] = len(sizes)
        traced["expected"] = work.by_group([x for n in sizes for x in s["launches"](n)])
    r.spans.clear()
    for k in ("items", "steps", "flops"):
        state[k] = 0

    # -- the window -----------------------------------------------------------
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    t_start = time.perf_counter()
    setup_s = t_start - r.t0
    while time.perf_counter() - t_start < r.seconds:
        one()
    sync()
    window_s = time.perf_counter() - t_start
    feed.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    items, steps_run, flops = state["items"], state["steps"], state["flops"]
    window_spans = {k: list(v) for k, v in r.spans.items()}

    # -- the check: the reference's steps from the program's states ----------
    gc.unfreeze()
    px_per_item = s["px_per_item"]
    del s, state, feed, one
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prog = program_steps(kept)
    ref = from_state.wsss_steps(cfg, init["G"], kept["states"][:KEPT_STEPS], kept["rows"],
                                reference_data(cfg, raw), vgg_params, dev)
    detail = {}
    checks = compare_steps.worst_of_steps(prog, ref, LOSSES, detail)
    detail["numbers"] = checks
    return {"kind": "train", "setup_s": setup_s, "window_s": window_s,
            "window_px": items * px_per_item,
            "steps": steps_run, "attempted": steps_run, "failed": 0,
            "model_flops": flops, "spans": window_spans, "memory_peak_bytes": memory_peak,
            "trace": traced, "program_spans": spans, "counters": counters,
            "checks": checks, "detail": detail, "setup_phases": r.setup_phases,
            "kept": kept, "raw": raw, "init_g": init["G"]}
