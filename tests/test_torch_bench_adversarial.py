"""The port's benchmark entry on the CPU at tiny sizes, its WSSS and RSSS
modes: ``--wsss`` and ``--rsss`` (the adversarial step alone), and
``--wsss-driver`` and ``--rsss-driver`` (the adversarial phase of the
driver loop), each line under the JAX bench's metric name and unit, the
pair, tile and batch counts against the JAX datasets and loaders
(``fcdgan_tpu.data``, no JAX step compiled) of the same sizes. Sizes: 32 px
slices and tiles (overlap 4), 24 px OSCD scenes, batches of 1 and 2, 2-scale
MS-SSIM, one warm and one timed step or epoch, bf16."""

import random

import pytest

from fcdgan_tpu_torch.tools import bench

from torch_bench_lines import CPU, MSW, PAD, PATCH
from torch_bench_lines import check as _check
from torch_bench_lines import lines as _lines
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("mode", ["wsss", "rsss"])
def test_adversarial_step(mode, capsys):
    fn = bench.bench_wsss if mode == "wsss" else bench.bench_rsss
    fn(CPU, batch=1, hw=PATCH, n_steps=1, msssim_weights=MSW)
    (line,) = _lines(capsys)
    _check(line, f"{mode}_adversarial_throughput", "Mpx/s")


def test_wsss_driver(capsys, tmp_path):
    from fcdgan_tpu.data.datasets import WHUPairDataset
    from fcdgan_tpu.data.device_cache import IndexPairBatchLoader
    from fcdgan_tpu_torch.data.synthetic import make_whu_dataset

    bench.bench_wsss_driver(CPU, epochs=1, n_pairs=3, hw=PATCH, batch=2, n_steps=1,
                            msssim_weights=MSW)
    (line,) = _lines(capsys)
    _check(line, "wsss_driver_adversarial_epochs_per_s", "epochs/s")
    paths = make_whu_dataset(str(tmp_path), n_changed=3, n_unchanged=3, size=PATCH)
    jds = WHUPairDataset(paths["before"], paths["after"], paths["Label"], str(tmp_path),
                         random_assign=False, rng=random.Random(0))
    jloader = IndexPairBatchLoader(jds, 2, shuffle=True, seed=0, tail="short")
    assert (line["pairs_per_epoch"], line["batches_per_epoch"]) == (len(jds), len(jloader))
    assert line["feed"] == "slice_cache" and len(line["s_losses"]) == 1
    assert line["mpx_per_s"] == pytest.approx(2 * len(jds) * PATCH ** 2 * line["value"] / 1e6)
    assert line["driver_frac_of_step"] == pytest.approx(line["mpx_per_s"]
                                                        / line["step_mpx_per_s"])


def test_rsss_driver(capsys, tmp_path):
    from fcdgan_tpu.data.datasets import OSCDDataset
    from fcdgan_tpu.data.device_cache import IndexBatchLoader
    from fcdgan_tpu_torch.data.synthetic import make_oscd_dataset

    bench.bench_rsss_driver(CPU, epochs=1, scene_px=24, hw=PATCH, batch=1, n_steps=1,
                            pad=PAD, msssim_weights=MSW)
    (line,) = _lines(capsys)
    _check(line, "rsss_driver_adversarial_epochs_per_s", "epochs/s")
    make_oscd_dataset(str(tmp_path), train_scenes=("alpha", "beta"), test_scenes=(),
                      xsize=24, ysize=24)
    jds = OSCDDataset(str(tmp_path), "train.txt", patch_size=(PATCH, PATCH),
                      overlap_padding=PAD)
    jloader = IndexBatchLoader(jds, 1, shuffle=True, seed=1, tail="short")
    assert (line["tiles_per_epoch"], line["batches_per_epoch"]) == (len(jds), len(jloader))
    assert (line["feed"], line["scene_px"]) == ("tile_cache", 24)
    assert line["mpx_per_s"] == pytest.approx(len(jds) * PATCH ** 2 * line["value"] / 1e6)
