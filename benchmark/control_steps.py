"""The readings that the limits of the cells checked step by step are set
from (``wsss-adv.whu600``, ``wsss-serve.whu``), as ``control`` takes them
for the others: the program's own, the control (the reference in the
program's place, its convolutions' operands and results rounded to float8
e4m3 and their gradients to e5m2, the precision below the configuration's
bfloat16) and, for training, the fault of half of each batch left out and
the fault of a step that leaves the state unchanged. Each is compared with
the float32 reference by the cell's own numbers (``compare_steps``;
``compare.density_gap`` for serving), at the cell's size, on the seeds
given:

    python -m benchmark.control_steps --workload <cell> --seeds 1,2,3 \\
        [--what program,fp8,half,unchanged] [--fault-seeds 8]

prints one JSON line a seed and reading: {"seed", "what", "numbers",
"detail"}. ``program`` is a run of the cell with a window of no length (the
same set-up, warm epoch or pass, and check as a benchmark run). A training
control or fault is taken from the states that run kept: each of its three
steps from the program's state before it, as the check takes the
reference's, and so a training reading runs the program whatever
``--what`` says. ``--fault-seeds n`` takes the control and the faults on
the first n seeds only.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import compare, compare_steps, harness
from benchmark.reference import from_state
from benchmark.reference import models as ref_models
from benchmark.reference import serve_slices as ref_serve
from benchmark.weights import init_state


def training_readings(r, device, what) -> Dict[str, Dict]:
    from benchmark.traffic import adversarial_loop as loop
    from benchmark.traffic import train_loop

    rec = harness.traffic(r.cell["traffic"]).run(r)
    out = {}
    if "program" in what:
        out["program"] = {"numbers": rec["checks"], "detail": {}}
    faults = [w for w in what if w in ("fp8", "half", "unchanged")]
    if not faults:
        return out
    cfg, kept = r.config, rec["kept"]
    states, rows = kept["states"][:loop.KEPT_STEPS], kept["rows"]
    data = train_loop.reference_data(cfg, rec["raw"])
    vgg = ref_models.vgg16_params(cfg["vgg_seed"])
    ref = from_state.wsss_steps(cfg, rec["init_g"], states, rows, data, vgg, device)
    for name in faults:
        if name == "unchanged":
            alt = compare_steps.unchanged(loop.program_steps(kept))
        else:
            kw = {"precision": "fp8"} if name == "fp8" else {"halve": True}
            alt = from_state.wsss_steps(cfg, rec["init_g"], states, rows, data, vgg, device,
                                        **kw)
        detail = {}
        numbers = compare_steps.worst_of_steps(alt, ref, loop.LOSSES, detail)
        out[name] = {"numbers": numbers, "detail": {"steps": [s["numbers"]
                                                              for s in detail["steps"]]}}
    return out


def serving_readings(r, device, what) -> Dict[str, Dict]:
    from benchmark.traffic import serve_slices

    out = {}
    if "program" in what:
        rec = harness.traffic(r.cell["traffic"]).run(r)
        out["program"] = {"numbers": rec["checks"], "detail": rec.get("detail", {})}
    if "fp8" not in what:
        return out
    cfg, c = r.config, r.config["bands"]
    with torch.device("meta"):
        shell = ref_models.Segmentor(c)
    weights = init_state(shell, r.seed, 0, device, r.params["weights"])
    nets = {}
    for prec in ("fp32", "fp8"):
        nets[prec] = ref_models.Segmentor(c, ref_models.QUANT[prec]).to(device)
        nets[prec].load_state_dict(weights)
    gap = 0.0
    for names, x, y, _, _ in serve_slices.slice_arrays(r):
        idx = np.argsort(names)  # the program's dataset order: the sorted names
        d = {k: ref_serve.densities(net, x[idx], y[idx], cfg["batch"], device)
             for k, net in nets.items()}
        gap = max(gap, compare.density_gap(d["fp8"], d["fp32"]))
    out["fp8"] = {"numbers": {"density_gap": gap}, "detail": {}}
    return out


def readings(cell_name: str, seed: int, device, what=("program", "fp8"),
             overrides: Optional[dict] = None) -> Dict[str, Dict]:
    """{reading: {"numbers", "detail"}} of ``cell_name`` on ``seed``."""
    with tempfile.TemporaryDirectory(prefix="fcdgan-control-") as work:
        r = harness.Run(cell_name, seed, 0, False, torch.device(device), work,
                        time.perf_counter(), overrides)
        if r.cell["traffic"] == "serve_slices":
            return serving_readings(r, torch.device(device), what)
        return training_readings(r, torch.device(device), what)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Program, control and fault readings of a cell "
                                 "checked step by step.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,fp8,half,unchanged")
    ap.add_argument("--fault-seeds", type=int, default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    what = tuple(args.what.split(","))
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        w = what if args.fault_seeds is None or i < args.fault_seeds else ("program",)
        for name, got in readings(args.workload, seed, args.device, w).items():
            print(json.dumps({"seed": seed, "what": name, **got}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
