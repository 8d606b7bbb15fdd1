"""The port's dataset tools (``fcdgan_tpu_torch/tools/{building_process,
oscd_process,convert_vgg}.py``) against the JAX tools: the WHU slicer and
the OSCD region writer on ``tests/test_tools.py``'s synthetic rasters (and
ragged and 16-bit variants of them), their output trees equal file for file
and byte for byte; the VGG16 converter on a random 13-conv ``features``
state_dict written under ``tmp_path``, read back by both packages'
``load_vgg16_params``."""

import os
import shutil

import numpy as np
import pytest
import torch

from fcdgan_tpu.data.tiff import TiffWriter
from fcdgan_tpu.tools import building_process as jax_building
from fcdgan_tpu.tools import oscd_process as jax_oscd
from fcdgan_tpu_torch.tools import building_process, convert_vgg, oscd_process


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("expand", [0, 3, 40])
def test_expand_regions_matches_jax(seed, expand):
    rng = np.random.default_rng(seed)
    mask = (rng.random((37, 53)) > 0.97).astype(np.uint8) * rng.integers(1, 256)
    mask[10:14, 12:18] = 255
    got = building_process.expand_regions(mask, expand)
    assert got.dtype == np.uint8 and got.shape == mask.shape
    np.testing.assert_array_equal(got, jax_building.expand_regions(mask, expand))


def _write_rasters(tmp_path, xsize, ysize, dtype):
    """before/after/label rasters as ``tests/test_tools.py`` writes them
    (random images, one changed block), in ``dtype``."""
    rng = np.random.default_rng(0)
    hi = 255 if dtype == np.uint8 else 300
    img = rng.integers(0, hi, (ysize, xsize, 3)).astype(dtype)
    img2 = rng.integers(0, hi, (ysize, xsize, 3)).astype(dtype)
    label = np.zeros((ysize, xsize), np.uint8)
    label[5:15, 5:20] = 1
    label[ysize - 6:ysize - 2, xsize - 9:xsize - 1] = 7
    for name, data, nb, dt in (("before.tif", img, 3, dtype), ("after.tif", img2, 3, dtype),
                               ("label.tif", label, 1, np.uint8)):
        with TiffWriter(str(tmp_path / name), xsize, ysize, nb, dt) as w:
            w.write_block(data)
    return [str(tmp_path / n) for n in ("before.tif", "after.tif", "label.tif")]


@pytest.mark.parametrize("xsize,ysize,dtype,sx,sy,expand", [
    (70, 50, np.uint8, 32, 32, 4),     # test_tools.py's case
    (70, 50, np.uint8, 25, 20, 0),     # ragged edge tiles, no growth
    (41, 33, np.uint16, 16, 16, 10)])  # 16-bit rasters (truncated to 8 bits, as in JAX)
def test_building_process_writes_the_jax_tree(tmp_path, xsize, ysize, dtype, sx, sy, expand):
    paths = _write_rasters(tmp_path, xsize, ysize, dtype)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_txt = jax_building.run(*paths, jax_out, slice_x=sx, slice_y=sy, region_expand=expand)
    txt = building_process.main(["--in-path", paths[0], "--ref-path", paths[1],
                                 "--label-path", paths[2], "--out-path", out,
                                 "--slice-x", str(sx), "--slice-y", str(sy),
                                 "--region-expand", str(expand)])
    assert os.path.relpath(txt, out) == os.path.relpath(jax_txt, jax_out) == "label.txt"
    got, want = _tree(out), _tree(jax_out)
    n_tiles = -(-xsize // sx) * -(-ysize // sy)
    assert len(want) == 4 * n_tiles + 1
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    labels = open(txt).read().split()
    assert "0_0.tif,0,0,1" in labels and len(labels) == n_tiles


def test_building_process_refuses_mismatched_rasters(tmp_path):
    a = _write_rasters(tmp_path, 20, 20, np.uint8)
    (tmp_path / "small").mkdir()
    b = _write_rasters(tmp_path / "small", 20, 18, np.uint8)
    with pytest.raises(ValueError, match="sizes don't match"):
        building_process.run(a[0], b[1], a[2], str(tmp_path / "out"))
    with pytest.raises(ValueError, match="sizes don't match"):
        building_process.run(a[0], a[1], b[2], str(tmp_path / "out"))


def test_oscd_process_writes_the_jax_region_rasters(tmp_path):
    from PIL import Image

    root = tmp_path / "oscd"
    for i, name in enumerate(("city", "town", "coast")):
        scene = root / name / "ImagePair"
        scene.mkdir(parents=True)
        cm = np.ones((30 + i, 34), np.uint8)  # 1 = unchanged
        cm[10:16, 10:18] = 2
        cm[2 + i:4 + i, 28:33] = 2
        Image.fromarray(cm).save(str(scene / f"{name}-cm.tif"))
    (root / "notes").mkdir()  # a directory without an ImagePair is skipped
    jax_root = tmp_path / "jax"
    shutil.copytree(root, jax_root)
    want = jax_oscd.run(str(jax_root), region_expand=5)
    got = oscd_process.main(["--in-path", str(root), "--region-expand", "5"])
    assert [os.path.relpath(p, root) for p in got] == [os.path.relpath(p, jax_root)
                                                       for p in want]
    assert len(got) == 3
    assert _tree(root) == _tree(jax_root)
    region = np.array(Image.open(str(root / "city" / "ImagePair" / "city-region.tif")))
    assert (region[5:21, 5:23] == 255).all() and region[25, 2] == 0


def test_oscd_process_needs_one_change_map_a_scene(tmp_path):
    (tmp_path / "city" / "ImagePair").mkdir(parents=True)
    with pytest.raises(ValueError, match="cannot be found"):
        oscd_process.run(str(tmp_path))


_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M")


def _features(convs=_VGG_CFG):
    """A seeded module shaped like torchvision's ``vgg16().features``."""
    torch.manual_seed(0)
    layers, c_in = [], 3
    for c in convs:
        if c == "M":
            layers.append(torch.nn.MaxPool2d(2, 2))
        else:
            layers += [torch.nn.Conv2d(c_in, c, 3, padding=1), torch.nn.ReLU(inplace=True)]
            c_in = c
    return torch.nn.Sequential(*layers)


@pytest.mark.parametrize("prefix", ["", "features."])
def test_convert_vgg_writes_what_both_packages_load(tmp_path, prefix):
    from fcdgan_tpu.models.vgg import load_vgg16_params as jax_load
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, load_vgg16_params

    net = _features()
    sd = {prefix + k: v for k, v in net.state_dict().items()}
    torch.save(sd, str(tmp_path / "vgg.pth"))
    out = str(tmp_path / "npz" / "vgg16_features.npz")
    assert convert_vgg.main(["--state-dict", str(tmp_path / "vgg.pth"), "--out", out]) == 13
    params = load_vgg16_params(out, require=True)
    assert params.keys() == jax_load(out, require=True).keys()
    convs = [m for m in net if isinstance(m, torch.nn.Conv2d)]
    assert sorted(params) == sorted([f"conv{i}_{k}" for i in range(13)
                                     for k in ("kernel", "bias")])
    for li, conv in enumerate(convs):
        np.testing.assert_array_equal(params[f"conv{li}_kernel"],
                                      conv.weight.detach().numpy().transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(params[f"conv{li}_bias"], conv.bias.detach().numpy())
    weights = VGG16Weights(params, "cpu")  # the OIHW weights the perception loss runs
    k, b = weights.get(3, torch.float32)
    assert torch.equal(k, convs[3].weight.detach()) and torch.equal(b, convs[3].bias.detach())


def test_convert_vgg_refuses_a_net_without_13_convs(tmp_path):
    torch.save(_features(_VGG_CFG[:-2]).state_dict(), str(tmp_path / "short.pth"))
    with pytest.raises(ValueError, match="expected 13 conv layers"):
        convert_vgg.convert(str(tmp_path / "short.pth"), str(tmp_path / "out.npz"))
    assert not (tmp_path / "out.npz").exists()
