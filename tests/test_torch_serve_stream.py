"""Scene serving off the fused path: the device feeds cache and stream,
quantized downloads, the upload type, scenes past the resident budget and
wide serving chunks, against the port's fused path and the JAX tool on one
seeded SModel.pkl; and the serving plumbing against the JAX package: the
chunk plan, ``BatchLoader``, ``run_overlapped``, the quantizer and the
config."""

import dataclasses
import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.data import pipeline as jax_pipeline
from fcdgan_tpu.data.device_cache import DeviceSceneWindowCache
from fcdgan_tpu.data.synthetic import make_usss_scene
from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Segmentor as JaxSegmentor
from fcdgan_tpu.tools import infer as jax_infer
from fcdgan_tpu_torch.data import pipeline as port_pipeline
from fcdgan_tpu_torch.data.device_cache import serve_chunks
from fcdgan_tpu_torch.data.raster import open_raster
from fcdgan_tpu_torch.eval.inference import run_overlapped
from fcdgan_tpu_torch.tools import infer as port_infer
from fcdgan_tpu_torch.utils.download import dequantize, quantize

SIDE = 80  # 9 tiles of 40 px at padding 4, 3 chunks of 3
THRESH = 0.1  # the seeded model's densities sit around it: both classes occur
SETTINGS = dict(patch_size=(40, 40), overlap_padding=(4, 4), batch_size=3,
                compute_dtype="float32", ref_name="ref.tif", prob_thresh=THRESH,
                progress=False)
# tag: (device_feed, density_dtype, transfer_dtype, environment)
RUNS = {"auto": ("auto", "float32", "", {}),
        "cache": ("cache", "float32", "", {}),
        "stream": ("stream", "float32", "", {}),
        "auto_uint8": ("auto", "uint8", "", {}),
        "stream_uint8": ("stream", "uint8", "", {}),
        "auto_bfloat16": ("auto", "bfloat16", "", {}),
        "stream_bfloat16": ("stream", "bfloat16", "", {}),
        "stream_transfer_bf16": ("stream", "float32", "bfloat16", {}),
        "past_budget": ("auto", "float32", "", {"FCDGAN_SCENE_CACHE_MAX_MB": "0.01"}),
        "serve_bs_32": ("auto", "float32", "", {"FCDGAN_SERVE_BS": "32"})}
JAX_RUNS = {"jax_auto": ("auto", "float32"), "jax_stream_uint8": ("stream", "uint8")}


def seeded_smodel(path: str, nband: int, side: int) -> None:
    """A seeded reference-format SModel.pkl with random BN statistics and a
    widened output conv, so the densities spread over (0, 1)."""
    model = JaxSegmentor(nband, bilinear=True)
    z = np.zeros((1, side, side, nband), np.float32)
    vs = model.init({"params": jax.random.PRNGKey(11)}, z, z, train=False)
    rng = np.random.default_rng(11)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 2.0, size=v.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.5, size=v.shape)).astype(np.float32),
        vs["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, vs["params"])
    conv = params["OutConv_0"]["TorchConv_0"]["Conv_0"]
    conv["kernel"] = conv["kernel"] * 50.0
    torch.save({k: torch.from_numpy(v) for k, v in variables_to_torch(params, stats).items()},
               path)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    jdir, pdir = str(root / "jax"), str(root / "port")
    make_usss_scene(jdir, SIDE, SIDE, 3, seed=6)
    shutil.copytree(jdir, pdir)
    smodel = str(root / "SModel.pkl")
    seeded_smodel(smodel, 3, 40)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("FCDGAN_SERVE_BS", "0")
        for tag, (feed, dd) in JAX_RUNS.items():
            out[tag] = jax_infer.run(jax_infer.InferConfig(
                dir=jdir, smodel=smodel, platform="cpu", device_feed=feed, density_dtype=dd,
                ext=f"_{tag}", **SETTINGS))
        for tag, (feed, dd, tdt, env) in RUNS.items():
            with pytest.MonkeyPatch.context() as m:
                for k, v in env.items():
                    m.setenv(k, v)
                out[tag] = port_infer.run(port_infer.InferConfig(
                    dir=pdir, smodel=smodel, device="cpu", device_feed=feed,
                    density_dtype=dd, transfer_dtype=tdt, ext=f"_{tag}", **SETTINGS))
    finally:
        mp.undo()
    for res in out.values():
        res["d"] = open_raster(res["density_path"]).read_block()[..., 0]
        res["c"] = open_raster(res["color_path"]).read_block()[..., 0]
    return out


def test_fused_path_only_where_asked_and_resident(served):
    assert {tag: served[tag]["fused"] for tag in RUNS} == {
        tag: feed == "auto" and not env.get("FCDGAN_SCENE_CACHE_MAX_MB")
        for tag, (feed, _, _, env) in RUNS.items()}
    d = served["auto"]["d"]
    assert d.shape == (SIDE, SIDE) and d.std() > 0.01
    assert all(served[tag]["pixels"] == SIDE * SIDE for tag in RUNS)


@pytest.mark.parametrize("tag", ["cache", "stream", "past_budget"])
def test_feeds_agree_with_the_fused_path(served, tag):
    """Cache and stream feeds (and auto past the budget, which streams)
    within 1e-6 of the fused density: the same tiles, normalized on the
    device or on the host."""
    np.testing.assert_allclose(served[tag]["d"], served["auto"]["d"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(served[tag]["c"], served["auto"]["c"])


@pytest.mark.parametrize("tag", ["auto", "cache", "stream"])
def test_paths_match_jax(served, tag):
    jax_out, got = served["jax_auto"], served[tag]
    np.testing.assert_allclose(got["d"], jax_out["d"], atol=5e-4)
    near = np.abs(jax_out["d"] - THRESH) <= 1e-3
    assert np.array_equal(got["c"][~near], jax_out["c"][~near])
    for key in ("oa", "f1"):
        assert np.isfinite(got[key])
        assert abs(got[key] - jax_out[key]) <= near.mean() + 1e-12


@pytest.mark.parametrize("feed", ["auto", "stream"])
def test_uint8_download(served, feed):
    """Within 1/510 of the port's f32 density (one rounding of d * 255), and
    its codes within 1 of the JAX tool's uint8 codes."""
    got, f32 = served[f"{feed}_uint8"]["d"], served[feed]["d"]
    np.testing.assert_allclose(got, f32, rtol=0, atol=1 / 510 + 1e-7)
    codes = np.rint(got * 255).astype(int)
    np.testing.assert_allclose(codes / 255.0, got, rtol=0, atol=1e-6)  # on the uint8 grid
    jax_codes = np.rint(served["jax_stream_uint8"]["d"] * 255).astype(int)
    assert np.abs(codes - jax_codes).max() <= 1


@pytest.mark.parametrize("feed", ["auto", "stream"])
def test_bfloat16_download(served, feed):
    got, f32 = served[f"{feed}_bfloat16"]["d"], served[feed]["d"]
    assert np.all(np.abs(got - f32) <= 2.0 ** -8 * np.abs(f32))
    assert np.array_equal(got, torch.from_numpy(got).to(torch.bfloat16).float().numpy())


def test_bfloat16_uploads_on_the_stream_path(served):
    np.testing.assert_allclose(served["stream_transfer_bf16"]["d"], served["stream"]["d"],
                               rtol=0, atol=2e-2)


def test_wide_serving_chunks_match_batch_exact_ones(served):
    np.testing.assert_allclose(served["serve_bs_32"]["d"], served["auto"]["d"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("env", [None, "0", "7", "32"])
def test_serve_chunks_match_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("FCDGAN_SERVE_BS", raising=False)
    else:
        monkeypatch.setenv("FCDGAN_SERVE_BS", env)
    for n in (1, 5, 9, 10, 33, 121):
        for bs in (1, 3, 10, 12, 32, 50):
            want = DeviceSceneWindowCache._serve_chunks(np.arange(n, dtype=np.int32), bs)
            got = serve_chunks(n, bs)
            assert got.shape == want.shape and np.array_equal(got, want), (n, bs)


class _Items:
    """A dataset of (x, item) samples."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 3), i, np.float32), i


@pytest.mark.parametrize("tail", ["pad", "short"])
@pytest.mark.parametrize("n,bs,shuffle,drop_last", [(10, 4, True, False), (3, 5, False, False),
                                                    (10, 4, True, True)])
def test_batch_loader_matches_jax(n, bs, shuffle, drop_last, tail):
    """Order, weights and the tail of two epochs at one seed."""
    kw = dict(fields=("x", "item"), shuffle=shuffle, seed=7, drop_last=drop_last, tail=tail)
    jl = jax_pipeline.BatchLoader(_Items(n), bs, **kw)
    pl = port_pipeline.BatchLoader(_Items(n), bs, **kw)
    assert len(pl) == len(jl)
    for _ in range(2):
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb)
        for a, b in zip(pb, jb):
            assert sorted(a) == sorted(b) == ["item", "weight", "x"]
            for key in a:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])


def test_prefetch_keeps_order_and_raises_the_source_error():
    assert list(port_pipeline.prefetch(iter(range(25)), depth=2)) == list(range(25))

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(port_pipeline.prefetch(failing()))


def test_run_overlapped_order_and_errors():
    """Every batch processed in order on another thread; an error in
    ``process`` propagates and does not deadlock the producer (the cases of
    the JAX package's tests/test_inference.py:103-130)."""
    seen = []
    main = threading.get_ident()
    run_overlapped(range(20), compute=lambda b: b * 2,
                   process=lambda out, b: seen.append((out, b, threading.get_ident())),
                   depth=3)
    assert [(o, b) for o, b, _ in seen] == [(i * 2, i) for i in range(20)]
    assert all(t != main for _, _, t in seen)

    computed = []

    def boom(out, b):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        run_overlapped(range(50), compute=lambda b: computed.append(b) or b, process=boom,
                       depth=2)
    assert len(computed) < 50  # the producer stopped early


def test_quantizers_match_the_jax_formulas():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(-0.2, 1.2, 4000),
                        np.arange(256) / 255.0, (np.arange(255) + 0.5) / 255.0,
                        [0.0, 1.0, -0.0, 0.5]]).astype(np.float32)
    want_u8 = np.asarray((jnp.clip(d, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8))
    got_u8 = quantize(torch.from_numpy(d), "uint8")
    assert got_u8.dtype == torch.uint8 and np.array_equal(got_u8.numpy(), want_u8)
    assert np.array_equal(dequantize(got_u8, "uint8"), want_u8.astype(np.float32) / 255.0)
    want_bf = np.asarray(jnp.asarray(d).astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(dequantize(quantize(torch.from_numpy(d), "bfloat16"), "bfloat16"),
                          want_bf)
    assert np.array_equal(dequantize(quantize(torch.from_numpy(d), "float32"), "float32"), d)
    with pytest.raises(ValueError):
        quantize(torch.from_numpy(d), "float16")


def test_config_has_every_jax_field():
    jax_fields = {f.name: f.default for f in dataclasses.fields(jax_infer.InferConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(port_infer.InferConfig)}
    del jax_fields["platform"]
    assert set(jax_fields) <= set(port_fields)
    assert {k: port_fields[k] for k in jax_fields} == jax_fields
    assert set(port_fields) - set(jax_fields) == {"device"}
