"""The port's VGG16 features against the JAX package's: the same random
weights from the same seed, the same taps from the same input."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fcdgan_tpu.models import vgg as jvgg
from fcdgan_tpu_torch.models import vgg as tvgg


def test_random_params_are_bit_equal_to_jax():
    ours, theirs = tvgg.vgg16_random_params(0), jvgg.vgg16_random_params(0)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("bands,taps", [(1, (29,)), (1, (29, 22, 15, 8, 3)), (3, (8, 3))])
def test_features_match_jax(bands, taps):
    params = tvgg.vgg16_random_params(0)
    x = np.random.default_rng(5).normal(size=(4, 32, 32, bands)).astype(np.float32)
    want = jvgg.vgg16_features(jnp.asarray(x), params, taps)
    got = tvgg.vgg16_features(torch.from_numpy(x), tvgg.VGG16Weights(params, "cpu"), taps)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        # the JAX package's torch-golden bound (tests/test_torch_parity.py:203)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4)


def test_weights_are_frozen_and_input_gradient_flows():
    w = tvgg.VGG16Weights(tvgg.vgg16_random_params(0), "cpu")
    x = torch.randn(2, 32, 32, 1, requires_grad=True)
    (f,) = tvgg.vgg16_features(x, w, (8,))
    f.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert not any(t.requires_grad for pair in w._f32.values() for t in pair)


def test_load_order_npz_env_then_random(tmp_path, monkeypatch):
    p = {k: v + 1 for k, v in tvgg.vgg16_random_params(1).items()}
    path = tmp_path / "vgg.npz"
    np.savez(path, **p)
    monkeypatch.delenv("FCDGAN_VGG16_NPZ", raising=False)
    got = tvgg.load_vgg16_params(str(path))
    np.testing.assert_array_equal(got["conv0_kernel"], p["conv0_kernel"])
    monkeypatch.setenv("FCDGAN_VGG16_NPZ", str(path))
    np.testing.assert_array_equal(tvgg.load_vgg16_params()["conv3_bias"], p["conv3_bias"])
    monkeypatch.setenv("FCDGAN_VGG16_NPZ", str(tmp_path / "missing.npz"))
    np.testing.assert_array_equal(tvgg.load_vgg16_params()["conv0_kernel"],
                                  tvgg.vgg16_random_params(0)["conv0_kernel"])
    with pytest.raises(FileNotFoundError):
        tvgg.load_vgg16_params(require=True)
    assert tvgg.select_feature_layers(1) == (29,)
    assert tvgg.select_feature_layers(9) == jvgg.select_feature_layers(9)
