"""The port stands alone: no jax, nothing of fcdgan_tpu, no silent CPU."""

import ast
import os
import subprocess
import sys

import pytest

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
        "print(len(mods)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20  # every module was imported


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


@pytest.mark.parametrize("kw", [dict(mode="whu"), dict(mode="oscd"),
                                dict(bn_mode="train"), dict(density_dtype="uint8"),
                                dict(device_feed="stream"), dict(n_devices=4)])
def test_unported_options_raise(kw, tmp_path):
    from fcdgan_tpu_torch.tools.infer import InferConfig, run

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run(InferConfig(dir=str(tmp_path), smodel="SModel.pkl", device="cpu", **kw))


def test_scene_past_the_cache_budget_raises(monkeypatch, tmp_path):
    from fcdgan_tpu_torch.data import device_cache
    from fcdgan_tpu_torch.data.synthetic import make_usss_scene
    from fcdgan_tpu_torch.io.checkpoint import save_net
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.tools.infer import InferConfig, run

    make_usss_scene(str(tmp_path), 40, 40, 3, seed=1)
    save_net(str(tmp_path / "SModel.pkl"), Segmentor(3))
    monkeypatch.setattr(device_cache, "SCENE_CACHE_MAX_BYTES", 1000)
    with pytest.raises(NotImplementedError, match="DeviceSceneWindowCache"):
        run(InferConfig(dir=str(tmp_path), smodel=str(tmp_path / "SModel.pkl"),
                        device="cpu", compute_dtype="float32",
                        patch_size=(24, 24), overlap_padding=(2, 2)))
    with pytest.raises(ValueError, match="convert_checkpoint"):
        run(InferConfig(dir=str(tmp_path), smodel=str(tmp_path), device="cpu"))
