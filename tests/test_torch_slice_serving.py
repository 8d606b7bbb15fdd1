"""WHU slice serving through ``eval.inference.slice_inference``, on the CPU:
``tools.infer --mode whu`` and the WSSS driver's final inference write the
files that their own loops wrote before they shared it (each loop is kept
here as it was, the reference); the densities against the benchmark's plain
float32 reference of train-mode-BN slice inference; and the function's
spans and counters."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.traffic import serve_slices
from fcdgan_tpu_torch.data.datasets import WHUDataset, WHUPairDataset
from fcdgan_tpu_torch.data.device_cache import DeviceWHUCache, IndexBatchLoader
from fcdgan_tpu_torch.data.normalize import Normalize
from fcdgan_tpu_torch.data.pipeline import BatchLoader
from fcdgan_tpu_torch.data.raster import write_image
from fcdgan_tpu_torch.data.stats import dataset_meanstd
from fcdgan_tpu_torch.data.synthetic import make_whu_dataset
from fcdgan_tpu_torch.demos import demo_wsss
from fcdgan_tpu_torch.eval.changemap import write_changemap
from fcdgan_tpu_torch.eval.inference import run_overlapped, slice_inference
from fcdgan_tpu_torch.io.checkpoint import load_segmentor
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.tools import infer
from fcdgan_tpu_torch.utils import timing
from fcdgan_tpu_torch.utils.timing import recording, span

from torch_threads import one_torch_thread  # noqa: F401

SIDE = 48
THRESH = 0.3
SLICE_PHASES = {"serve.slices.read", "serve.slices.pass", "serve.slices.download",
                "serve.slices.write"}


def _dirs(root):
    return (os.path.join(root, "before"), os.path.join(root, "after"),
            os.path.join(root, "Label"), root)


def _scaler(dirs):
    return Normalize(*dataset_meanstd(os.path.join(dirs[0], "stats_meanstd.txt"),
                                      os.path.join(dirs[1], "stats_meanstd.txt"),
                                      WHUDataset(*dirs, "-1")))


def _nhwc_forward(net, x, y):
    with torch.no_grad():
        return net(torch.as_tensor(np.ascontiguousarray(x)).permute(0, 3, 1, 2),
                   torch.as_tensor(np.ascontiguousarray(y)).permute(0, 3, 1, 2)
                   ).permute(0, 2, 3, 1).numpy()


def _write(out_dir, density_dir, name, density, ref_mask):
    """The writes of both loops as they were: the grey density, the color map."""
    change = (density > THRESH).astype(np.int16)
    write_image(os.path.join(density_dir, name), np.uint8(density * 255))
    cw = write_changemap(change, ref_mask, True)
    write_image(os.path.join(out_dir, name), np.uint8(cw.transpose((1, 2, 0))))


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


@pytest.fixture(scope="module")
def whu(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("whu"))
    make_whu_dataset(root, n_changed=5, n_unchanged=3, size=SIDE, seed=3)
    torch.manual_seed(3)
    net = Segmentor(3)
    for m in net.modules():  # checkpoint statistics unlike any batch's
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    smodel = os.path.join(root, "SModel.pkl")
    torch.save(net.state_dict(), smodel)
    return root, smodel


@pytest.mark.parametrize("bn", ["train", "eval"])
def test_run_whu_writes_what_its_loop_wrote(whu, tmp_path, bn, one_torch_thread):
    root, smodel = whu
    dirs = _dirs(root)
    out = infer.run(infer.InferConfig(
        mode="whu", smodel=smodel, bn_mode=bn, batch_size=2, device="cpu",
        compute_dtype="float32", prob_thresh=THRESH, progress=False,
        outdir=str(tmp_path / "tool"), img_dir_x=dirs[0], img_dir_y=dirs[1], ref_dir=dirs[2],
        label_dir=root))
    # the loop run_whu ran before (5 changed slices in batches of 2: the tail
    # batch holds one slice and one wrap-padded duplicate)
    ds = WHUDataset(*dirs, label_selected="1", scale=_scaler(dirs))
    net = load_segmentor(smodel).train(bn == "train")
    want, want_d = str(tmp_path / "loop"), str(tmp_path / "loop_Density")
    os.makedirs(want)
    os.makedirs(want_d)
    for b in BatchLoader(ds, 2, fields=("x", "y", "ref", "item", "label"), shuffle=False):
        n = int(b["weight"].sum()) if bn == "train" else len(b["weight"])
        cmap = _nhwc_forward(net, b["x"][:n], b["y"][:n])
        for ns in range(len(cmap)):
            if b["weight"][ns] == 0:
                continue
            _write(want, want_d, ds.get_file_name(int(b["item"][ns])), cmap[ns, :, :, 0],
                   b["ref"][ns][:, :, 0])
    _same_files(out["out_dir"], want)
    _same_files(out["density_dir"], want_d)
    assert out["pixels"] == 5 * SIDE * SIDE


@pytest.mark.parametrize("cache", ["auto", "off"])
def test_the_wsss_drivers_final_inference_writes_what_its_loop_wrote(whu, tmp_path, cache,
                                                                      one_torch_thread):
    root, _ = whu
    dirs = _dirs(root)
    out_dir = str(tmp_path / "demo")
    res = demo_wsss.main([
        "--img-dir-x", dirs[0], "--img-dir-y", dirs[1], "--ref-dir", dirs[2],
        "--label-dir", root, "--out-g-model-dir", str(tmp_path / "G"), "--device", "cpu",
        "--msssim-weights", "0.5,0.5", "--batch-size", "2", "--unc-batch-size", "2",
        "--init-num-epochs-g", "1", "--num-epochs", "1", "--log-tensorboard", "false",
        "--progress", "false", "--slice-cache", cache, "--seed", "5", "--out-dir", out_dir,
        "--prob-thresh", str(THRESH)])
    assert (res["feed"] == "resident") == (cache == "auto")
    # the loop the driver ran before, on the trained S in train mode (its
    # densities do not read the running buffers the inference moved)
    net = res["sstate"].train()
    scaler = _scaler(dirs)
    want, want_d = str(tmp_path / "loop"), str(tmp_path / "loop_Density")
    os.makedirs(want)
    os.makedirs(want_d)
    if cache == "auto":
        pair_ds = WHUPairDataset(*dirs, scale=scaler)
        c_ds, dc = pair_ds.c_ds, DeviceWHUCache(pair_ds, scaler, "cpu")
        batches = IndexBatchLoader(pair_ds.c_len, 2, tail="short")
    else:
        c_ds = WHUDataset(*dirs, label_selected="1", scale=scaler)
        batches = BatchLoader(c_ds, 2, fields=demo_wsss.FIELDS, tail="short")
    for b in batches:
        if cache == "auto":
            db = dc.complete_c(b)
            x, y = db["x"].numpy(), db["y"].numpy()
        else:
            x, y = b["x"], b["y"]
        cmap = _nhwc_forward(net, x, y)[..., 0]
        for ns, item in enumerate(b["item"]):
            item = int(item)
            ref = (dc.cref_host[item, :, :, 0] if cache == "auto"
                   else b["ref"][ns][:, :, 0]).astype(np.int16)
            _write(want, want_d, c_ds.get_file_name(item), cmap[ns], ref)
    _same_files(res["density_dir"], want_d)
    for n in os.listdir(want):  # beside the maps: Para.txt and the models
        with open(os.path.join(out_dir, n), "rb") as fa, open(os.path.join(want, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_the_densities_match_the_train_mode_reference(tmp_path, one_torch_thread):
    """The serving cell's driver at a small size in float32: each set's
    densities, as ``slice_inference`` downloaded them, against the plain
    reference's train-mode densities of the raw pairs in the same batches."""
    ov = {"sets": 2, "changed": 3, "unchanged": 2, "profile_sets": 1,
          "config": {"slice": 40, "batch": 2, "compute_dtype": "float32"}}
    r = harness.Run("wsss-serve.whu", 2 ** 33 + 5, 0.0, True, torch.device("cpu"),
                    str(tmp_path), time.perf_counter(), ov)
    rec = serve_slices.run(r)
    # float32 on both sides; the statistics cache holds the program's mean
    # and std in text, the reference's are float64: a few float32 roundings
    assert rec["checks"]["density_gap"] < 1e-5
    assert rec["counters"]["serve.slices_written"] == 5  # the profiled set
    assert rec["counters"]["serve.write_bytes"] == 5 * (40 * 40 + 40 * 40 * 3)
    for name in ("read_ms_per_mpx.whu", "write_ms_per_mpx.whu"):
        assert harness.metric_reader(name).read(rec) > 0


def test_slice_spans_nest_under_their_root_and_count_the_slices(whu, tmp_path,
                                                                one_torch_thread):
    root, smodel = whu
    dirs = _dirs(root)
    ds = WHUDataset(*dirs, label_selected="-1", scale=_scaler(dirs))
    net = load_segmentor(smodel)
    out, dens = str(tmp_path / "o"), str(tmp_path / "d")
    os.makedirs(out)
    os.makedirs(dens)
    with recording() as rec:
        res = slice_inference(ds, net, 3, "cpu", out, dens, prob_thresh=THRESH,
                              keep_densities=True)
    (top,) = [s for s in rec.spans if s.name == "serve.slices"]
    by_id = {s.id: s for s in rec.spans}
    assert {s.name for s in rec.spans} == SLICE_PHASES | {"serve.slices"}
    for s in rec.spans:
        if s is not top:
            assert s.parent == top.id and top.start <= s.start <= s.end <= top.end
    assert {by_id[s.parent].name for s in rec.spans if s.parent is not None} == {"serve.slices"}
    batches = -(-len(ds) // 3)
    assert sum(s.name == "serve.slices.pass" for s in rec.spans) == batches
    assert sum(s.name == "serve.slices.read" for s in rec.spans) == batches + 1  # the end
    assert res["slices"] == len(ds) == rec.counters["serve.slices_written"] == 8
    assert rec.counters["serve.write_bytes"] == 8 * (SIDE * SIDE + SIDE * SIDE * 3)
    assert sorted(res["densities"]) == list(range(8))
    assert all(d.shape == (SIDE, SIDE) for d in res["densities"].values())


def test_without_a_recording_the_spans_cost_nothing(whu, tmp_path, one_torch_thread):
    root, smodel = whu
    dirs = _dirs(root)
    ds = WHUDataset(*dirs, label_selected="1", scale=_scaler(dirs))
    assert timing._recording is None
    assert span("serve.slices") is span("serve.slices.write") is timing._NULL
    res = slice_inference(ds, load_segmentor(smodel), 2, "cpu", str(tmp_path), prob_thresh=THRESH)
    assert res["slices"] == 5 and res["densities"] is None
    assert timing._recording is None and timing.open_ids() == ()


def test_a_writer_threads_spans_nest_under_the_callers():
    seen = []
    with recording() as rec:
        with span("caller"):
            run_overlapped(range(3), compute=lambda b: b,
                           process=lambda out, b: _spanned(seen))
    (caller,) = [s for s in rec.spans if s.name == "caller"]
    written = [s for s in rec.spans if s.name == "written"]
    assert len(written) == 3 and all(s.parent == caller.id for s in written)
    assert all(s.thread != threading.get_ident() for s in written)
    assert timing.open_ids() == ()


def _spanned(seen):
    with span("written"):
        seen.append(threading.get_ident())
