"""Train-mode BatchNorm as a custom autograd function on the channel-sum kernels.

Port of the JAX package's ``ops/fused_bn.py`` (``bn_train``, ``_bn_fwd_impl``,
``_bn_bwd``, :77-154) with one phase group and no cross-device mean. The
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

from .channel_sums import channel_sums, channel_sums_pair
from .layout import nhwc


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x_nhwc = nhwc(x)
        x = x_nhwc.permute(0, 3, 1, 2)
        n = x.numel() // x.shape[1]
        s, ss = channel_sums(x_nhwc, square=True)
        mean = s / n
        var = torch.clamp(ss / n - mean.square(), min=0.0)
        r = torch.rsqrt(var + eps)
        dt = x.dtype
        y = (x - _col(mean.to(dt))) * _col((scale * r).to(dt)) + _col(bias.to(dt))
        ctx.save_for_backward(x, scale, mean, r)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, r = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        dy_nhwc = nhwc(dy)
        sdy, sdyx = channel_sums_pair(dy_nhwc, x.permute(0, 2, 3, 1))
        dscale = r * (sdyx - mean * sdy)
        a = scale * r
        b = -(a * r * dscale) / n
        d = (-a * sdy + a * r * dscale * mean) / n
        dx = None
        if ctx.needs_input_grad[0]:
            dyf = dy_nhwc.permute(0, 3, 1, 2).float()
            dx = torch.addcmul(torch.addcmul(_col(d), dyf, _col(a)), x.float(),
                               _col(b)).to(x.dtype)
        return dx, dscale, sdy, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BN of NCHW ``x`` with f32 per-channel ``scale`` and ``bias``:
    ``(y, mean, var)``, ``y`` in x's dtype and memory format, the batch
    ``mean`` and biased ``var`` f32 and without gradient."""
    return _BNTrain.apply(x, scale, bias, eps)
