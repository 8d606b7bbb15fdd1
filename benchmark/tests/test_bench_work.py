"""The work counts of ``benchmark/work.py``: model FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` running the frozen reference
at a small size on the CPU, and the roofline arithmetic and launch lists
against hand values."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import models, steps

torch.set_num_threads(2)


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _nets(names, c):
    torch.manual_seed(0)
    return models.nets(names, c)


def _vgg():
    return models.VGG16(models.vgg16_params(0), "cpu")


CFG = {"vgg_tap": 29, "perception_weight": 0.4, "l1_weight": 0.65, "ssim_weight": 0.0,
       "g_weight": 0.2, "d_weight": 1.0, "nc_weight": 1.5, "msssim_weights": [0.5, 0.5]}


@pytest.mark.parametrize("b,p,c", [(2, 48, 3), (1, 64, 4)])
def test_usss_joint_flops_match_the_flop_counter(b, p, c):
    nets = _nets(("G", "S"), c)
    g, s = nets["G"], nets["S"]
    batch = {"x": torch.randn(b, c, p, p), "y": torch.randn(b, c, p, p), "weight": torch.ones(b)}
    opt_g, opt_s = steps.Adam(g.parameters()), steps.Adam(s.parameters())
    got = _counted(lambda: steps.usss_joint(g, s, opt_g, opt_s, _vgg(), CFG, batch, 1e-5))
    assert got == work.usss_joint_flops(b, p, c, levels=2)


def test_wsss_adversarial_flops_match_the_flop_counter():
    b, p, c = 2, 48, 3
    nets = _nets(("G", "S", "D"), c)
    batch = {k: torch.randn(b, c, p, p) for k in ("c_x", "c_y", "nc_x", "nc_y")}
    batch["weight"] = torch.ones(b)
    opt_s, opt_d = steps.RMSprop(nets["S"].parameters()), steps.RMSprop(nets["D"].parameters())
    got = _counted(lambda: steps.wsss_adversarial(nets["G"], nets["S"], nets["D"], opt_s, opt_d,
                                                  _vgg(), CFG, batch, 1e-4, 1e-6))
    assert got == work.wsss_adversarial_flops(b, p, c, levels=2)


@pytest.mark.parametrize("p", [48, 60])
def test_serve_tile_flops_match_the_flop_counter(p):
    s = _nets(("S",), 3)["S"].eval()
    x = torch.randn(1, 3, p, p)
    with torch.no_grad():
        got = _counted(lambda: s(x, x))
    assert got == work.serve_tile_flops(p, 3)


def test_roofline_hand_values():
    assert work.roofline_s(3.35e12, 0, "bfloat16") == pytest.approx(1.0)
    assert work.roofline_s(0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert work.roofline_s(0, 67e12, "float32") == pytest.approx(1.0)
    assert work.roofline_s(3.35e9, 989e9, "bfloat16") == pytest.approx(1e-3)
    # conv3x3 on (1, 8, 8, 4) -> 2 channels, bf16: x 256 + w 72 + y 128 elements
    _, nbytes, ops, dt = work.conv3x3(1, 8, 8, 4, 2)
    assert (nbytes, ops, dt) == ((256 + 72 + 128) * 2, 2 * 64 * 9 * 4 * 2, "bfloat16")
    # pool_bwd on (1, 4, 4, 2): x read and dx written (32 each), dy read (8)
    assert work.pool_bwd(1, 4, 4, 2)[1:3] == ((32 + 32 + 8) * 2, 7 * 8)
    # phase_pool on (1, 5, 5, 1): the even 4 x 4 read, 2 x 2 written
    assert work.phase_pool(1, 5, 5, 1)[1:3] == ((16 + 4) * 2, 12)
    assert work.channel_sums(1, 2, 2, 3)[1:3] == (12 * 2 + 24, 36)
    assert work.channel_sums_pair(1, 2, 2, 3)[1:3] == (24 * 2 + 24, 36)


def test_launch_lists_are_the_programs_counts():
    """The launches a step makes, as the program's own counts give them
    (conv3x3 / pool_bwd / fused_ssim / channel_sums + pair / phase_pool):
    USSS joint 14 / 8 / 5 / 29 + 29 / 8, WSSS adversarial 17 / 12 / 5 /
    45 + 45 / 12, a serving chunk 3 conv3x3 and 4 phase_pool."""
    def counts(launches):
        return {g: v["launches"] for g, v in work.by_group(launches).items()}

    assert counts(work.usss_joint_launches(10, 220, 3, "bfloat16")) == {
        "conv3x3": 14, "pool_bwd": 8, "fused_ssim": 5, "channel_sums": 58, "phase_pool": 8}
    assert counts(work.wsss_adversarial_launches(15, 200, 3, "bfloat16")) == {
        "conv3x3": 17, "pool_bwd": 12, "fused_ssim": 5, "channel_sums": 90, "phase_pool": 12}
    assert counts(work.serve_chunk_launches(32, 220, 3, "bfloat16")) == {
        "conv3x3": 3, "phase_pool": 4}


def test_ssim_levels_follow_the_padded_pooling():
    assert [lv[1] for lv in work.ssim_levels(1, 220, 220, 3)] == [220, 110, 55, 28, 14]
    assert [lv[1] for lv in work.ssim_levels(1, 200, 200, 3)] == [200, 100, 50, 25, 13]
    x = torch.zeros(1, 1, 55, 55)
    assert torch.nn.functional.avg_pool2d(x, 2, padding=1).shape[-1] == 28
    assert np.prod(work.ssim_levels(2, 64, 48, 4)[1]) == 2 * 32 * 24 * 4
