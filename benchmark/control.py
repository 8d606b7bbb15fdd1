"""The readings that a cell's limits are set from: the program's own, the
control (the reference in the program's place, its convolutions' operands
and results rounded to float8 e4m3 and their gradients to e5m2, the
precision below the configuration's bfloat16) and, for a training cell,
the fault of half of each batch left out (the reference's step on the
first half). Each is compared with the float32 reference by the cell's own
numbers (``compare``), at the cell's size, on the seeds given:

    python -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--what program,fp8,half] [--dtype float32]

prints one JSON line a seed and reading: {"seed", "what", "numbers",
"detail"}. ``program`` is a run of the cell with a window of no length:
the same set-up, the same first steps or warm pass and the same check as
a benchmark run, and so the same numbers; ``--dtype`` runs the program in
another compute type (a second witness beside the reference). A state left
unchanged reads 1 by ``change_gap`` and needs no run. The rows of the
control's three steps are the first three batches of a seeded permutation
of the cell's items (neither side is the program).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import compare, harness
from benchmark.reference import strict_fp32
from benchmark.reference import models as ref_models
from benchmark.reference import serve as ref_serve
from benchmark.reference import train as ref_train
from benchmark.weights import init_state


def _rows(cfg: Dict, data, seed: int):
    """Three batches of distinct items from a seeded permutation."""
    rng, b = np.random.default_rng(seed), cfg["batch"]
    ones = np.ones(b, np.float32)
    if cfg["mode"] == "usss":
        order = rng.permutation(len(data.grid))
        return [{"item": order[i * b:(i + 1) * b], "weight": ones} for i in range(3)]
    c, u = rng.permutation(cfg["n_changed"]), rng.permutation(cfg["n_unchanged"])
    return [{"c_item": c[i * b:(i + 1) * b], "nc_item": u[i * b:(i + 1) * b], "weight": ones}
            for i in range(3)]


def training_readings(r, device, what) -> Dict[str, Dict]:
    from benchmark.traffic import train_loop

    if not {"fp8", "half"} & set(what):
        return {}
    cfg = r.config
    raw = train_loop.raw_data(r)
    init = train_loop.init_states(cfg, r.seed, device, train_loop.NETS[cfg["mode"]])
    data = train_loop.reference_data(cfg, raw)
    rows = _rows(cfg, data, r.seed)
    vgg = ref_models.vgg16_params(cfg["vgg_seed"])
    start = train_loop.trained_params(cfg["mode"], init)
    base = ref_train.first_steps(cfg, init, data, rows, vgg, device)
    out = {}
    for name, kw in (("fp8", {"precision": "fp8"}), ("half", {"halve": True})):
        if name not in what:
            continue
        alt = ref_train.first_steps(cfg, init, data, rows, vgg, device, **kw)
        detail = {}
        numbers = compare.training_checks(alt["losses"], alt["grads"],
                                          compare.changes(alt["params"], start), base,
                                          start, detail)
        out[name] = {"numbers": numbers, "detail": detail}
    return out


def serving_readings(r, device, what) -> Dict[str, Dict]:
    from benchmark.traffic import serve_closed_loop

    if "fp8" not in what:
        return {}
    cfg, p = r.config, r.params
    with torch.device("meta"):
        shell = ref_models.Segmentor(cfg["bands"])
    weights = init_state(shell, r.seed, 0, device, p["weights"])
    nets = {}
    for prec in ("fp32", "fp8"):
        nets[prec] = ref_models.Segmentor(cfg["bands"], ref_models.QUANT[prec]).to(device)
        nets[prec].load_state_dict(weights)
    gap = 0.0
    for sc in serve_closed_loop.scene_arrays(r):
        d = {k: ref_serve.density(net, sc[1], sc[2], cfg["patch"], cfg["pad"], device)
             for k, net in nets.items()}
        gap = max(gap, compare.density_gap(d["fp8"], d["fp32"]))
    return {"fp8": {"numbers": {"density_gap": gap}, "detail": {}}}


def program_readings(r) -> Dict[str, Dict]:
    """A run of the cell with a window of no length: the check's numbers."""
    rec = harness.traffic(r.cell["traffic"]).run(r)
    detail = dict(rec.get("detail") or {})
    detail.pop("numbers", None)
    return {"program": {"numbers": rec["checks"], "detail": detail}}


def readings(cell_name: str, seed: int, device, overrides: Optional[dict] = None,
             what=("fp8", "half")) -> Dict[str, Dict]:
    """{reading: {"numbers", "detail"}} of ``cell_name`` on ``seed``."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="fcdgan-control-") as work:
        r = harness.Run(cell_name, seed, 0, False, torch.device(device), work,
                        time.perf_counter(), overrides)
        if "program" in what:
            out.update(program_readings(r))
        if r.cell["traffic"] == "serve_closed_loop":
            out.update(serving_readings(r, torch.device(device), what))
        else:
            out.update(training_readings(r, torch.device(device), what))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Program, control and fault readings of a cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="fp8,half")
    ap.add_argument("--dtype", default=None, help="the program's compute type, if not the "
                    "configuration's")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    what = tuple(args.what.split(","))
    if args.dtype == "float32":
        strict_fp32()  # the program's float32 without TF32, as the reference runs
    overrides = {"config": {"compute_dtype": args.dtype}} if args.dtype else None
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, got in readings(args.workload, seed, args.device, overrides, what).items():
            print(json.dumps({"seed": seed, "what": name, "dtype": args.dtype, **got}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
