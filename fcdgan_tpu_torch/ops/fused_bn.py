"""Train-mode BatchNorm as a custom autograd function on the channel-sum kernels.

Port of the JAX package's ``ops/fused_bn.py`` (``bn_train``, ``_bn_fwd_impl``,
``_bn_bwd``, :77-154) with one phase group. The
forward takes the f32 statistics (sum x, sum x^2) from one
``channel_sums(x, square=True)``; ``mean = s/n``, ``var = max(ss/n - mean^2,
0)`` (biased), ``r = rsqrt(var + eps)``, and normalizes in the activation
dtype as ``(x - mean)*(scale*r) + bias``, the cast coefficients of the JAX
function. It saves only ``x``, ``scale``, ``mean`` and ``r``.

The backward takes (sum dy, sum dy*x) from one ``channel_sums_pair(dy, x)``
and forms, per channel,

    dscale = r*(sum dy*x - mean*sum dy),   dbias = sum dy,
    dx = a*dy + b*x + d   with a = scale*r, b = -scale*r^2*dscale/n,
                               d = -scale*r*sum dy/n + scale*r^2*dscale*mean/n.

Unlike the JAX function, which casts a, b and d to the activation dtype,
each dx element is evaluated in f32 and rounded once: in bf16, b*x and d
cancel when |mean| >> std, and the rounded coefficients would lose the
difference. In f32 the two agree to rounding.

Under a process group (``parallel.mesh``) the statistics are the global
batch's, as under the JAX function's ``axis_name`` (fused_bn.py:88-102,
121-130): the kernels' per-rank sums are all-reduced, (sum x, sum x^2)
and then (sum dy, sum dy*x), each pair as one buffer, and ``n`` is the
rank's count times the world. ``dx`` takes the global sums; the gradients
of ``scale`` and ``bias`` are this rank's parts, which the train step sums
over the ranks with the other parameters' gradients. The forward's buffer
carries the rank's count as well, and each rank checks on the device that
the total is its own count times the world, so every rank's count is the
same (the padded batch slices make it so).

``mean`` and ``var`` come back marked non-differentiable: the port consumes
them only in the running-stat update under ``no_grad``, so their cotangent
terms (``dmean_ct``, ``dvar_ct`` in the JAX function) are always zero.

Tensors are NCHW in channels_last memory, as everywhere in the port: their
NHWC views go to the kernels. A ``dy`` that reaches the backward in another
layout is copied first (``ops.layout.nhwc``, which counts the copies).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel import mesh
from .channel_sums import channel_sums, channel_sums_pair
from .layout import nhwc


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _global_moments(s: torch.Tensor, ss: torch.Tensor, n_local: int):
    """(sum x, sum x^2, n) over the ranks from one all-reduce of a 2C + 1
    buffer whose last element is the rank's count."""
    c = s.numel()
    buf = torch.cat([s, ss, s.new_full((1,), float(n_local))])
    mesh.all_reduce_sum(buf)
    n = n_local * mesh.world()
    torch._assert_async(buf[2 * c] == n, "train-mode BN: the ranks' batch slices differ in size")
    return buf[:c], buf[c:2 * c], n


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x_nhwc = nhwc(x)
        x = x_nhwc.permute(0, 3, 1, 2)
        n = x.numel() // x.shape[1]
        s, ss = channel_sums(x_nhwc, square=True)
        ctx.data_parallel = mesh.active()
        if ctx.data_parallel:
            s, ss, n = _global_moments(s, ss, n)
        mean = s / n
        var = torch.clamp(ss / n - mean.square(), min=0.0)
        r = torch.rsqrt(var + eps)
        dt = x.dtype
        y = (x - _col(mean.to(dt))) * _col((scale * r).to(dt)) + _col(bias.to(dt))
        ctx.save_for_backward(x, scale, mean, r)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, r = ctx.saved_tensors
        n = ctx.n
        dy_nhwc = nhwc(dy)
        sdy, sdyx = channel_sums_pair(dy_nhwc, x.permute(0, 2, 3, 1))
        dscale = dscale_part = r * (sdyx - mean * sdy)
        dbias_part = sdy
        if ctx.data_parallel:  # dx takes the global sums; scale and bias get
            c = sdy.numel()    # this rank's part, which the step sums
            buf = mesh.all_reduce_sum(torch.cat([sdy, sdyx]))[0]
            sdy, sdyx = buf[:c], buf[c:]
            dscale = r * (sdyx - mean * sdy)
        a = scale * r
        b = -(a * r * dscale) / n
        d = (-a * sdy + a * r * dscale * mean) / n
        dx = None
        if ctx.needs_input_grad[0]:
            dyf = dy_nhwc.permute(0, 3, 1, 2).float()
            dx = torch.addcmul(torch.addcmul(_col(d), dyf, _col(a)), x.float(),
                               _col(b)).to(x.dtype)
        return dx, dscale_part, dbias_part, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BN of NCHW ``x`` with f32 per-channel ``scale`` and ``bias``:
    ``(y, mean, var)``, ``y`` in x's dtype and memory format, the batch
    ``mean`` and biased ``var`` f32 and without gradient."""
    return _BNTrain.apply(x, scale, bias, eps)
