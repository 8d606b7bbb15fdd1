"""The work of a training step and of a served scene, counted from the
configuration's shapes: the model FLOPs of every convolution (forward, and
the input and weight gradients that the step computes), and the bytes and
operations of each launch of the program's six kernels (conv3x3,
channel_sums and channel_sums_pair, pool_bwd, phase_pool, fused_ssim).

Model FLOPs count the networks as the reference defines them (a band fed
to the VGG replicated to RGB, the MS-SSIM blurs as depthwise convolutions),
so they are the same whatever kernel computes them. A kernel launch counts
each input byte read once and each output byte written once, and its
operations from its shapes; its least time is the larger of bytes over the
memory rate and operations over the peak rate of its type (H100 SXM data
sheet, dense).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12  # B/s, HBM3
MFU_PEAK = PEAK_FLOPS["bfloat16"]
SSIM_WIN = 11
MSSSIM_LEVELS = 5
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def roofline_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least seconds of a launch: bytes or operations at the peak rate."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


@dataclasses.dataclass(frozen=True)
class Conv:
    """A convolution on an (n, h, w, cin) input, 'same' padding k // 2."""
    n: int
    h: int
    w: int
    cin: int
    cout: int
    k: int = 3
    stride: int = 1

    @property
    def out_hw(self) -> Tuple[int, int]:
        p = self.k // 2
        return ((self.h + 2 * p - self.k) // self.stride + 1,
                (self.w + 2 * p - self.k) // self.stride + 1)

    @property
    def flops(self) -> int:
        ho, wo = self.out_hw
        return 2 * self.n * ho * wo * self.cin * self.cout * self.k * self.k

    @property
    def out(self) -> Tuple[int, int, int, int]:
        return (self.n, *self.out_hw, self.cout)


# -- the networks' convolutions ----------------------------------------------

def _levels(h: int, w: int, n: int = 4) -> List[Tuple[int, int]]:
    out = [(h, w)]
    for _ in range(n):
        out.append((out[-1][0] // 2, out[-1][1] // 2))
    return out


def segmentor_convs(n: int, h: int, w: int, c: int) -> List[Conv]:
    """S on n pairs: the encoder on both dates stacked, the decoder on n."""
    e, lv = 2 * n, _levels(h, w)
    out = [Conv(e, h, w, c, 64), Conv(e, h, w, 64, 64)]
    for (cin, cout), (hh, ww) in zip(((64, 128), (128, 256), (256, 512), (512, 512)), lv[1:]):
        out += [Conv(e, hh, ww, cin, cout), Conv(e, hh, ww, cout, cout)]
    for cin, cout, level in ((2048, 512, 3), (1024, 256, 2), (512, 128, 1), (256, 128, 0)):
        hh, ww = lv[level]
        out += [Conv(n, hh, ww, cin, cin // 2), Conv(n, hh, ww, cin // 2, cout)]
    return out + [Conv(n, h, w, 128, 1, k=1)]


def segmentor_pools(n: int, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """NHWC inputs of S's four max pools (the encoder, both dates)."""
    return [(2 * n, hh, ww, c) for (hh, ww), c in zip(_levels(h, w), (64, 128, 256, 512))]


def generator_convs(n: int, h: int, w: int, c: int) -> List[Conv]:
    return ([Conv(n, h, w, c, 64, k=9)] + [Conv(n, h, w, 64, 64)] * 11
            + [Conv(n, h, w, 64, c, k=9)])


def discriminator_convs(n: int, h: int, w: int, c: int) -> List[Conv]:
    """D on n pairs stacked: four stride-2 convs, then the 1x1 classifier."""
    out, hh, ww = [], h, w
    for cin, cout in ((c, 64), (64, 128), (128, 256), (256, 512)):
        conv = Conv(2 * n, hh, ww, cin, cout, stride=2)
        out.append(conv)
        hh, ww = conv.out_hw
    return out + [Conv(n, 1, 1, 512, 1024, k=1), Conv(n, 1, 1, 1024, 1, k=1)]


VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def vgg_convs(n: int, h: int, w: int) -> List[Conv]:
    """VGG16 ``features`` to relu5_3 on n RGB planes."""
    out, cin = [], 3
    for (cout, reps), (hh, ww) in zip(VGG_STAGES, _levels(h, w)):
        for _ in range(reps):
            out.append(Conv(n, hh, ww, cin, cout))
            cin = cout
    return out


def vgg_pools(n: int, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """NHWC inputs of the four pools before relu5_3."""
    return [(n, hh, ww, c) for (hh, ww), (c, _) in zip(_levels(h, w), VGG_STAGES[:4])]


def ssim_levels(n: int, h: int, w: int, c: int, levels: int = MSSSIM_LEVELS
                ) -> List[Tuple[int, int, int, int]]:
    """The (n, h, w, c) of each MS-SSIM level (2x2 average pooling padded
    by the odd extent)."""
    out = [(n, h, w, c)]
    for _ in range(levels - 1):
        hh, ww = out[-1][1], out[-1][2]
        out.append((n, (hh + 2 * (hh % 2) - 2) // 2 + 1, (ww + 2 * (ww % 2) - 2) // 2 + 1, c))
    return out


def ssim_blur_flops(n: int, h: int, w: int, c: int, levels: int = MSSSIM_LEVELS) -> int:
    """Forward FLOPs of the MS-SSIM blurs: five maps a level, each a valid
    depthwise K x 1 then 1 x K convolution."""
    total, k = 0, SSIM_WIN
    for nn_, hh, ww, cc in ssim_levels(n, h, w, c, levels):
        vh, vw = hh - k + 1, ww - k + 1
        total += 5 * 2 * nn_ * cc * k * (vh * ww + vh * vw)
    return total


def train_flops(convs: Iterable[Conv], dw: bool = True, dx_first: bool = False) -> int:
    """Forward + input gradients (all but the first conv unless
    ``dx_first``) + weight gradients (when ``dw``)."""
    convs = list(convs)
    f = sum(c.flops for c in convs)
    dx = f - (0 if dx_first else convs[0].flops)
    return f + dx + (f if dw else 0)


def forward_flops(convs: Iterable[Conv]) -> int:
    return sum(c.flops for c in convs)


# -- model FLOPs per item ----------------------------------------------------

def usss_joint_flops(b: int, p: int, c: int, levels: int = MSSSIM_LEVELS) -> int:
    """A USSS joint step on b tiles of p px with c bands: G and S trained,
    the per-band VGG through both images, the MS-SSIM metric."""
    return (train_flops(generator_convs(b, p, p, c)) + train_flops(segmentor_convs(b, p, p, c))
            + train_flops(vgg_convs(2 * c * b, p, p), dw=False, dx_first=True)
            + ssim_blur_flops(b, p, p, c, levels))


def wsss_adversarial_flops(b: int, p: int, c: int, levels: int = MSSSIM_LEVELS) -> int:
    """A WSSS adversarial step on b changed and b unchanged pairs: S trained
    on both, D stepped on two passes and differentiated for S on a third,
    the frozen G forward, the RGB VGG through both images, the metric."""
    s = segmentor_convs(b, p, p, c)
    d = discriminator_convs(b, p, p, c)
    return (2 * train_flops(s) + 2 * train_flops(d) + train_flops(d, dw=False, dx_first=True)
            + forward_flops(generator_convs(b, p, p, c))
            + train_flops(vgg_convs(2 * b, p, p), dw=False, dx_first=True)
            + ssim_blur_flops(b, p, p, c, levels))


def serve_tile_flops(p: int, c: int) -> int:
    """One tile pair through the eval-mode Segmentor."""
    return forward_flops(segmentor_convs(1, p, p, c))


# -- the program's kernel launches ------------------------------------------

Launch = Tuple[str, int, int, str]  # (kernel group, bytes, operations, peak type)


def conv3x3(n, h, w, ci, co, dtype="bfloat16") -> Launch:
    it = ITEMSIZE[dtype]
    return ("conv3x3", (n * h * w * (ci + co) + 9 * ci * co) * it, 2 * n * h * w * 9 * ci * co,
            dtype)


def channel_sums(n, h, w, c, dtype="bfloat16") -> Launch:
    m = n * h * w * c
    return ("channel_sums", m * ITEMSIZE[dtype] + 2 * c * 4, 3 * m, "float32")


def channel_sums_pair(n, h, w, c, dtype="bfloat16") -> Launch:
    m = n * h * w * c
    return ("channel_sums", 2 * m * ITEMSIZE[dtype] + 2 * c * 4, 3 * m, "float32")


def phase_pool(n, h, w, c, dtype="bfloat16") -> Launch:
    out = n * (h // 2) * (w // 2) * c
    return ("phase_pool", (4 * out + out) * ITEMSIZE[dtype], 3 * out, "float32")


def pool_bwd(n, h, w, c, dtype="bfloat16") -> Launch:
    dy = n * (h // 2) * (w // 2) * c
    return ("pool_bwd", (2 * n * h * w * c + dy) * ITEMSIZE[dtype], 7 * dy, "float32")


def fused_ssim(n, h, w, c) -> Launch:
    k = SSIM_WIN
    vh, vw = h - k + 1, w - k + 1
    return ("fused_ssim", 2 * n * h * w * c * 4 + 2 * n * c * 4,
            n * c * (3 * h * w + 10 * k * vh * w + (10 * k + 20) * vh * vw), "float32")


def _gated(convs: Sequence[Conv]) -> List[Conv]:
    """The 3x3 stride-1 convs that the program routes to conv3x3 (C_in <= 64,
    C_out <= 128, H and W >= 8)."""
    return [c for c in convs if c.k == 3 and c.stride == 1 and c.cin <= 64 and c.cout <= 128
            and c.h >= 8 and c.w >= 8]


def _bn_inputs(convs: Sequence[Conv]) -> List[Tuple[int, int, int, int]]:
    return [c.out for c in convs]


def usss_joint_launches(b: int, p: int, c: int, dtype: str, levels: int = MSSSIM_LEVELS
                        ) -> List[Launch]:
    g, s = generator_convs(b, p, p, c), segmentor_convs(b, p, p, c)
    convs = _gated(g) + _gated(s)
    bns = _bn_inputs(g[1:12]) + _bn_inputs(s[:18])
    pools = segmentor_pools(b, p, p) + vgg_pools(2 * c * b, p, p)
    return ([conv3x3(k.n, k.h, k.w, k.cin, k.cout, dtype) for k in convs]
            + [channel_sums(*x, dtype) for x in bns] + [channel_sums_pair(*x, dtype) for x in bns]
            + [phase_pool(*x, dtype) for x in pools] + [pool_bwd(*x, dtype) for x in pools]
            + [fused_ssim(*x) for x in ssim_levels(b, p, p, c, levels)])


def wsss_adversarial_launches(b: int, p: int, c: int, dtype: str, levels: int = MSSSIM_LEVELS
                              ) -> List[Launch]:
    g, s = generator_convs(b, p, p, c), segmentor_convs(b, p, p, c)
    d = discriminator_convs(b, p, p, c)
    convs = 2 * _gated(s) + _gated(g)
    bns = 2 * _bn_inputs(s[:18]) + 3 * _bn_inputs(d[1:4])
    pools = 2 * segmentor_pools(b, p, p) + vgg_pools(2 * b, p, p)
    return ([conv3x3(k.n, k.h, k.w, k.cin, k.cout, dtype) for k in convs]
            + [channel_sums(*x, dtype) for x in bns] + [channel_sums_pair(*x, dtype) for x in bns]
            + [phase_pool(*x, dtype) for x in pools] + [pool_bwd(*x, dtype) for x in pools]
            + [fused_ssim(*x) for x in ssim_levels(b, p, p, c, levels)])


def serve_chunk_launches(bs: int, p: int, c: int, dtype: str) -> List[Launch]:
    """One fused serving chunk of bs tile pairs (eval-mode BN: no sums)."""
    s = segmentor_convs(bs, p, p, c)
    return ([conv3x3(k.n, k.h, k.w, k.cin, k.cout, dtype) for k in _gated(s)]
            + [phase_pool(*x, dtype) for x in segmentor_pools(bs, p, p)])


def by_group(launches: Iterable[Launch]) -> Dict[str, Dict[str, float]]:
    """{group: {"launches", "bound_s"}} of a list of launches."""
    out: Dict[str, Dict[str, float]] = {}
    for group, nbytes, ops, dtype in launches:
        g = out.setdefault(group, {"launches": 0, "bound_s": 0.0})
        g["launches"] += 1
        g["bound_s"] += roofline_s(nbytes, ops, dtype)
    return out
