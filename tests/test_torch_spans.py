"""The program's spans and counters (``utils/timing.py``): the recorder
itself, and the spans placed in the USSS joint step and the resident scene
serving path, on the CPU."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from fcdgan_tpu_torch.data.datasets import ScenePairDataset
from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
from fcdgan_tpu_torch.data.normalize import Normalize
from fcdgan_tpu_torch.data.synthetic import make_usss_scene
from fcdgan_tpu_torch.eval.inference import stitched_inference
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
from fcdgan_tpu_torch.ops import layout
from fcdgan_tpu_torch.tools import profile_train
from fcdgan_tpu_torch.train.optim import adam
from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps
from fcdgan_tpu_torch.utils import timing
from fcdgan_tpu_torch.utils.timing import count, maybe_profile, recording, span

from torch_threads import one_torch_thread  # noqa: F401

STEP_PHASES = ["step.forward", "step.loss", "step.backward", "step.optimizer"]
SERVE_PHASES = {"feed.read", "feed.upload", "serve.pass", "serve.download", "serve.write"}
NORM = Normalize([100.0, 101.0, 99.0], [30.0, 29.0, 31.0],
                 [105.0, 104.0, 106.0], [28.0, 30.0, 29.0])


def _children(rec, parent):
    return [s for s in sorted(rec.spans, key=lambda s: s.start) if s.parent == parent.id]


def _one(rec, name):
    (s,) = [s for s in rec.spans if s.name == name]
    return s


# -- the recorder ---------------------------------------------------------------
def test_off_nothing_is_recorded_or_counted():
    assert timing._recording is None
    a, b = span("a"), span("b")
    assert a is b is timing._NULL
    with a:
        count("c", 3)
    with recording() as rec:
        pass
    assert timing._recording is None and span("a") is timing._NULL
    assert list(rec.spans) == [] and rec.counters == {} and rec.dropped == 0


def test_nesting_gives_parents_and_threads():
    def other():
        with span("thread.root"):
            with span("thread.child"):
                count("n", 2)

    with recording() as rec:
        with span("root"):
            with span("child"):
                with span("grandchild"):
                    count("n")
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    root, child, grand = (_one(rec, n) for n in ("root", "child", "grandchild"))
    troot, tchild = _one(rec, "thread.root"), _one(rec, "thread.child")
    assert root.parent is None and child.parent == root.id and grand.parent == child.id
    assert troot.parent is None and tchild.parent == troot.id  # not the other thread's root
    assert root.thread == child.thread == threading.get_ident() != troot.thread
    assert root.start <= child.start <= grand.start <= grand.end <= child.end <= root.end
    assert rec.counters == {"n": 3}


def test_self_time_is_the_duration_less_the_children():
    with recording() as rec:
        with span("root"):
            for _ in range(2):
                with span("child"):
                    sum(range(20000))
            sum(range(20000))
    root = _one(rec, "root")
    kids = _children(rec, root)
    own = rec.self_seconds()
    assert len(kids) == 2
    assert own[root.id] == pytest.approx(
        (root.end - root.start) - sum(k.end - k.start for k in kids), abs=1e-12)
    assert all(own[k.id] == k.end - k.start for k in kids)
    assert 0 < own[root.id] < root.end - root.start


def test_the_bounded_buffer_drops_the_oldest():
    with recording(max_spans=3) as rec:
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4"] and rec.dropped == 2


def test_a_span_never_synchronizes(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with span("off"):
        torch.ones(2) + 1
    with recording() as rec, span("on"):
        torch.ones(2) + 1
    with recording(annotate=True) as rec2, span("annotated"):
        torch.ones(2) + 1
    assert [s.name for s in rec.spans] == ["on"] and [s.name for s in rec2.spans] == ["annotated"]


def test_maybe_profile_puts_the_spans_on_the_trace(tmp_path):
    with maybe_profile(str(tmp_path), cuda=False) as rec:
        with span("serve.pass"):
            torch.ones(8) * 2
    assert [s.name for s in rec.spans] == ["serve.pass"] and timing._recording is None
    (trace,) = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "serve.pass" in names


def test_layout_copies_are_the_recorders_counter():
    assert not hasattr(layout, "copies")
    nchw = torch.zeros(2, 3, 4, 5)
    cl = nchw.to(memory_format=torch.channels_last)

    def step():
        layout.nhwc(nchw)
        layout.nhwc(cl)  # free: its NHWC view is contiguous
        layout.nhwc(nchw)

    wall, prof, copies = profile_train.profiled_step(step, torch.device("cpu"))
    assert copies == 2 and wall > 0 and timing._recording is None
    layout.nhwc(nchw)  # off: not counted anywhere
    with recording() as rec:
        step()
    assert rec.counters == {"layout.nhwc_copies": 2}


# -- the spans placed in the program -----------------------------------------------
HW, PAD = 32, (4, 4)


def _joint_step(record: bool):
    torch.manual_seed(0)
    g, s = Generator(3), Segmentor(3)
    steps = USSSSteps(g, s, adam(g.parameters()), adam(s.parameters()),
                      VGG16Weights(vgg16_random_params(0), "cpu"), PerceptionConfig((3,), True),
                      0.4, 0.65, 0.0, np.array([[HW - 8, HW - 8]] * 4, np.int32), PAD,
                      msssim_weights=(0.5, 0.5))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, HW, HW, 3)).astype(np.float32))
    y = x * 0.9 + 0.1
    y[:, 10:20, 10:20, :] += 2.0
    ref = torch.ones(2, HW, HW, 1)
    item, w = torch.tensor([0, 3]), torch.ones(2)
    if record:
        with recording() as rec:
            m = steps.joint(x, y, ref, item, w, 1e-4, 1e-4)
    else:
        rec, m = None, steps.joint(x, y, ref, item, w, 1e-4, 1e-4)
    params = [p.detach().clone() for net in (g, s) for p in net.parameters()]
    return m, params, rec


def test_a_joint_step_records_its_four_phases(one_torch_thread):
    m_on, p_on, rec = _joint_step(True)
    m_off, p_off, _ = _joint_step(False)
    root = _one(rec, "step")
    assert root.parent is None
    assert [k.name for k in _children(rec, root)] == STEP_PHASES
    assert sorted(s.name for s in rec.spans) == sorted(["step"] + STEP_PHASES)
    for k in m_on:  # recording changes nothing the step computes
        assert torch.equal(m_on[k], m_off[k]), k
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))


def test_resident_serving_records_its_phases(tmp_path, monkeypatch, one_torch_thread):
    def refuse(*a, **k):
        raise AssertionError("the serving path synchronized on the CPU")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    make_usss_scene(str(tmp_path), 72, 72, 3, seed=5, dtype=np.uint16,
                    rects=((10, 12, 14, 10), (40, 38, 16, 20)))
    torch.manual_seed(3)
    net = Segmentor(3).eval()

    def serve(name):
        ds = ScenePairDataset(str(tmp_path / "T1.tif"), str(tmp_path / "T2.tif"),
                              ref_path=str(tmp_path / "ref.tif"), enhance=NORM,
                              out_path=str(tmp_path / name), patch_size=(32, 32),
                              overlap_padding=PAD)
        return ds, stitched_inference(ds, net, 3, "cpu")

    with recording() as rec:
        ds, on = serve("on.tif")
    _, off = serve("off.tif")
    assert on["feed"] == "resident" and on["fused"]
    np.testing.assert_array_equal(on["density"], off["density"])
    root = _one(rec, "serve.scene")
    kids = _children(rec, root)
    assert root.parent is None and {k.name for k in kids} == SERVE_PHASES
    assert [k.name for k in kids].count("feed.upload") == 3  # x, y and the reference
    assert [k.name for k in kids if k.name.startswith("serve.")] == \
        ["serve.pass", "serve.download", "serve.write"]
    assert {s.name for s in rec.spans} == SERVE_PHASES | {"serve.scene"}
    assert rec.counters == {"feed.upload_bytes": DeviceSceneCache.scene_bytes(ds)}
    # the call's seconds are the root's interval: the read, upload and write count
    assert sum(k.end - k.start for k in kids) <= on["seconds"] <= root.end - root.start
    assert on["px_per_s"] == pytest.approx(72 * 72 / on["seconds"])
