"""Shared by the bench tests: the JSON lines a bench run printed, and the
checks every line passes (metric name, unit, a finite positive value,
``vs_baseline``), at the tests' tiny sizes."""

import json
import math

import torch

CPU = torch.device("cpu")
MSW = (0.5, 0.5)  # 2-scale MS-SSIM
PATCH, PAD, SCENE = 32, (4, 4), 48


def lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def check(line, metric, unit, baseline=-1.0):
    """``baseline``: the ``vs_baseline`` the line must print; None: any
    positive ratio (an in-run A/B)."""
    assert line["metric"] == metric and line["unit"] == unit
    assert math.isfinite(line["value"]) and line["value"] > 0
    if baseline is None:
        assert line["vs_baseline"] > 0
    else:
        assert line["vs_baseline"] == baseline
