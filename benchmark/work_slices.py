"""The work of a WHU slice pass (the final inference of the WSSS mode),
counted from the configuration's shapes as ``work`` counts a step's: the
model FLOPs of the Segmentor's forward on n slice pairs, and the launches
of the program's kernels in its train-mode forward, where each of S's 18
BatchNorms takes its batch statistics from one ``channel_sums`` launch
(sums and squares)."""

from __future__ import annotations

from typing import List

from .work import Launch, _bn_inputs, _gated, channel_sums, conv3x3, forward_flops, phase_pool
from .work import segmentor_convs, segmentor_pools

S_BATCHNORMS = 18  # every conv of S's encoder and decoder but the 1x1 output


def slice_pass_flops(n: int, p: int, c: int) -> int:
    """S's forward on n pairs of p px slices with c bands."""
    return forward_flops(segmentor_convs(n, p, p, c))


def slice_pass_launches(n: int, p: int, c: int, dtype: str) -> List[Launch]:
    """The kernel launches of S's train-mode forward on n pairs."""
    s = segmentor_convs(n, p, p, c)
    return ([conv3x3(k.n, k.h, k.w, k.cin, k.cout, dtype) for k in _gated(s)]
            + [channel_sums(*x, dtype) for x in _bn_inputs(s[:S_BATCHNORMS])]
            + [phase_pool(*x, dtype) for x in segmentor_pools(n, p, p)])
