"""Run one cell of the benchmark once, on the card it is started on.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads/<cell>.json``) names its configuration and its
traffic driver; the driver builds the program under test from the seed,
warms every shape it will use, measures for ``--seconds``, and checks what
the window produced against the plain reference. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, from ``BENCHMARK.json``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error.

Without a CUDA card, or with fewer than the cell asks for, the run prints
no result and exits 3. If JAX or the JAX package is loaded once the window
has closed, it names them on standard error and exits 4.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Optional  # noqa: E402

from benchmark import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fcdgan_tpu")
CACHE_DIR = os.path.join(harness.ROOT, ".bench_cache")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``fcdgan_tpu_torch`` is not ``fcdgan_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def _chips(bench: dict, cell_name: str) -> int:
    for w in bench["workloads"]:
        if w["name"] == cell_name:
            return int(w["chips"])
    raise KeyError(f"{cell_name} is not a workload of BENCHMARK.json")


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             overrides: Optional[dict] = None, bench: Optional[dict] = None,
             t0: Optional[float] = None) -> dict:
    """One run of ``cell_name`` on ``device``: the result line as a dict."""
    import torch

    bench = bench or harness.spec()
    chips = _chips(bench, cell_name)
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="fcdgan-bench-") as work:
        r = harness.Run(cell_name, seed, seconds, trace, device, work,
                        _T0 if t0 is None else t0, overrides)
        record = harness.traffic(r.cell["traffic"]).run(r)
    metrics = {}
    for m in harness.metrics_for(bench, cell_name, trace):
        value = harness.metric_reader(m["name"]).read(record)
        if value is None:
            print(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = harness.judge(record["checks"], r.cell["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(record["memory_peak_bytes"]),
           "power": power_limit() if device.type == "cuda" else "not measured"}
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": int(record["attempted"]), "failed": int(record["failed"]),
              "metrics": metrics, "device": dev}
    if trace:
        tr = record["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["wall_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    print("setup " + json.dumps(record.get("setup_phases", {})), file=sys.stderr)
    print("window spans " + json.dumps({k: [len(v), 1e3 * sum(v) / max(len(v), 1)]
                                        for k, v in record.get("spans", {}).items()}),
          file=sys.stderr)
    if record.get("detail"):
        print("detail " + json.dumps(record["detail"]), file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches stay at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE_DIR, "torch_extensions"))
    import torch

    bench = harness.spec()
    chips = _chips(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
