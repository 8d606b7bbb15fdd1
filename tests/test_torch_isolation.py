"""The port stands alone: no jax, nothing of fcdgan_tpu, no silent CPU."""

import ast
import os
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fcdgan_tpu_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax", "fcdgan_tpu")


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_importing_every_module_loads_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import fcdgan_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'fcdgan_tpu'))\n"
        "print(len(mods)); assert not bad, bad\n"
        "assert 'fcdgan_tpu_torch.parallel.mesh' in mods\n"
        "assert {'fcdgan_tpu_torch.tools.' + t for t in ('bench', 'building_process', "
        "'oscd_process', 'convert_vgg')} <= set(mods)\n"
        "import fcdgan_tpu_torch.native as n\n"
        "assert n._lib is None and n._error is None  # nothing built or loaded\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20  # every module was imported


def _native_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".cpp", ".cu")):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_native_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_native_sources_use_nothing_of_jax(path):
    """The C++ and CUDA sources include nothing of the JAX package; the
    host C++ library (the port's own copy) does not name it at all (the
    CUDA sources cite the TPU kernel each one replaces)."""
    import re

    with open(path) as f:
        text = f.read()
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)", text, re.M)
    assert not any(re.search(r"fcdgan_tpu(?!_torch)|jax", i, re.I) for i in includes)
    if path.endswith(".cpp"):
        assert not re.search(r"fcdgan_tpu(?!_torch)|jax", text, re.I)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_run_without_cpu_request_raises_without_gpu(monkeypatch, tmp_path):
    import torch

    from fcdgan_tpu_torch.tools.infer import InferConfig, run
    from fcdgan_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(InferConfig(dir=str(tmp_path), smodel="SModel.pkl"))
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("kw,item", [
    (dict(siamese_stats="split"), "A.3"), (dict(n_devices=4), "A.4"),
    (dict(mode="whu", siamese_stats="split"), "A.3"), (dict(mode="oscd", n_devices=2), "A.4"),
    (dict(bn_mode="train", siamese_stats="split"), "A.3"),
    (dict(device_feed="stream", density_dtype="uint8", n_devices=2), "A.4")])
def test_unported_options_raise(kw, item, tmp_path):
    """The serving options of ROADMAP.md queue A, in every mode.
    ``--siamese-stats split`` (A.3) runs on the CPU, in eval mode with the
    densities of the joint Segmentor within f32 rounding (1e-5).
    ``--n-devices`` (A.4) raises past the GPUs there are, and on two gloo
    ranks on the CPU gives the densities of one process (oscd mode and the
    quantized stream of the scene mode: within f32 rounding and one uint8
    step)."""
    import numpy as np
    import torch

    from fcdgan_tpu_torch.data.raster import open_raster, read_image
    from fcdgan_tpu_torch.data.synthetic import (make_oscd_dataset, make_usss_scene,
                                                 make_whu_dataset)
    from fcdgan_tpu_torch.io.checkpoint import save_net
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.tools.infer import InferConfig, run

    if kw.get("n_devices") == 4:
        with pytest.raises(ValueError, match=f"need 4 devices, have {torch.cuda.device_count()}"):
            run(InferConfig(dir=str(tmp_path), smodel="SModel.pkl", device="cuda", **kw))
        return
    torch.manual_seed(0)
    nband = 4 if kw.get("mode") == "oscd" else 3
    save_net(str(tmp_path / "SModel.pkl"), Segmentor(nband))
    common = dict(smodel=str(tmp_path / "SModel.pkl"), device="cpu", compute_dtype="float32",
                  patch_size=(32, 32), overlap_padding=(4, 4), batch_size=2, progress=False)
    if kw.get("mode") == "whu":
        make_whu_dataset(str(tmp_path), n_changed=3, n_unchanged=1, size=32, seed=1)
        common.update(img_dir_x=str(tmp_path / "before"), img_dir_y=str(tmp_path / "after"),
                      ref_dir=str(tmp_path / "Label"), label_dir=str(tmp_path))
    elif kw.get("mode") == "oscd":
        make_oscd_dataset(str(tmp_path), xsize=48, ysize=48, rects=((5, 6, 10, 8),), seed=1)
        common.update(dir=str(tmp_path))
    else:
        make_usss_scene(str(tmp_path), 40, 40, 3, seed=1)
        common.update(dir=str(tmp_path), ref_name="ref.tif")
    runs = ({"joint": dict(siamese_stats="joint"), "split": dict(siamese_stats="split")}
            if item == "A.3" else {"one": dict(n_devices=0), "two": dict(n_devices=2)})
    dens = {}
    for tag, over in runs.items():
        out = run(InferConfig(**{**common, **kw, **over}, outdir=str(tmp_path / tag),
                              ext=f"_{tag}"))
        if kw.get("mode") == "whu":
            dens[tag] = np.stack([read_image(os.path.join(out["density_dir"], n))
                                  for n in sorted(os.listdir(out["density_dir"]))])
        elif kw.get("mode") == "oscd":
            dens[tag] = np.stack([open_raster(os.path.join(
                str(tmp_path), scene, "ImagePair", out["density_name"])).read_block()
                for scene in out["scenes"]])
        else:
            dens[tag] = open_raster(out["density_path"]).read_block()
        assert np.isfinite(out["oa"])
    first, second = dens.values()
    assert second.shape == first.shape and second.size
    tol = (1.0 if kw.get("mode") == "whu"  # whu: uint8 images, one grey level
           else 1 / 255 + 1e-6 if kw.get("density_dtype") == "uint8" else 1e-5)
    np.testing.assert_allclose(second.astype(np.float64), first, atol=tol)


def test_scene_past_the_cache_budget_raises(monkeypatch, tmp_path):
    """Past ``FCDGAN_SCENE_CACHE_MAX_MB`` the resident cache refuses the
    scene, naming the streaming path and the unported window cache, and the
    tool streams it instead."""
    from fcdgan_tpu_torch.data.datasets import ScenePairDataset
    from fcdgan_tpu_torch.data.device_cache import DeviceSceneCache
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene
    from fcdgan_tpu_torch.io.checkpoint import save_net
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.tools.infer import InferConfig, run

    make_usss_scene(str(tmp_path), 40, 40, 3, seed=1)
    save_net(str(tmp_path / "SModel.pkl"), Segmentor(3))
    monkeypatch.setenv("FCDGAN_SCENE_CACHE_MAX_MB", "0.001")
    ds = ScenePairDataset(str(tmp_path / "T1.tif"), str(tmp_path / "T2.tif"),
                          patch_size=(24, 24), overlap_padding=(2, 2))
    assert not DeviceSceneCache.supports(ds)
    with pytest.raises(NotImplementedError, match="DeviceSceneWindowCache"):
        DeviceSceneCache(ds, None, "cpu")
    out = run(InferConfig(dir=str(tmp_path), smodel=str(tmp_path / "SModel.pkl"),
                          device="cpu", compute_dtype="float32", progress=False,
                          patch_size=(24, 24), overlap_padding=(2, 2)))
    assert not out["fused"] and out["pixels"] == 40 * 40
    with pytest.raises(ValueError, match="convert_checkpoint"):
        run(InferConfig(dir=str(tmp_path), smodel=str(tmp_path), device="cpu"))
