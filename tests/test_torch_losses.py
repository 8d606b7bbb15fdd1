"""The port's USSS loss stack against the JAX package's: values and
gradients of cnet_loss, with the same VGG weights and inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.ops import losses as JL
from fcdgan_tpu_torch.models.vgg import VGG16Weights, vgg16_random_params
from fcdgan_tpu_torch.ops import losses as TL

HW = 32
MSW = (0.5, 0.5)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(9)
    y = rng.normal(size=(2, HW, HW, 3)).astype(np.float32)
    g = (y + rng.normal(scale=0.3, size=y.shape)).astype(np.float32)
    cmap = rng.uniform(size=(2, HW, HW, 1)).astype(np.float32)
    w = np.array([1.0, 0.5], np.float32)
    params = vgg16_random_params(0)
    return dict(y=y, g=g, cmap=cmap, w=w, params=params,
                vgg=VGG16Weights(params, "cpu"))


def _jax_terms(case, per_band, mask_switch, target_grad=True, layers=(29, 8)):
    def f(g, cmap):
        return JL.cnet_loss(jnp.asarray(case["y"]), g, cmap, case["params"], layers,
                            perception_per_band=per_band,
                            generator_mask_switch=mask_switch, msssim_weights=MSW,
                            sample_weight=jnp.asarray(case["w"]),
                            perception_target_grad=target_grad)
    return f


@pytest.mark.parametrize("per_band,mask_switch", [(True, False), (False, True)])
def test_cnet_loss_values_and_gradients_match_jax(case, per_band, mask_switch):
    f = _jax_terms(case, per_band, mask_switch)
    combo = (1.0, 0.65, 0.4, 0.3)  # gen + l1w*l1 + pw*perc + sw*ssim, sw != 0

    def total(g, c):
        terms = f(g, c)
        return sum(a * t for a, t in zip(combo, terms)), terms

    (_, terms), (jg, jc) = jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))(
        jnp.asarray(case["g"]), jnp.asarray(case["cmap"]))
    want = [float(v) for v in terms]

    g = torch.from_numpy(case["g"]).requires_grad_()
    cmap = torch.from_numpy(case["cmap"]).requires_grad_()
    got = TL.cnet_loss(torch.from_numpy(case["y"]), g, cmap, case["vgg"], (29, 8),
                       perception_per_band=per_band, generator_mask_switch=mask_switch,
                       msssim_weights=MSW, sample_weight=torch.from_numpy(case["w"]))
    np.testing.assert_allclose([float(v.detach()) for v in got], want, rtol=1e-5)
    sum(a * t for a, t in zip(combo, got)).backward()
    # the train-step gradient tolerance of tests/test_steps.py:180
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jg), rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(cmap.grad.numpy(), np.asarray(jc), rtol=2e-3, atol=2e-5)


def test_forward_only_target_branch_and_ssim_switches(case):
    """G pretrain's forward-only target pass gives the same value; at SSIM
    weight 0 the SSIM term carries no graph; with compute_ssim off it is 0."""
    y, g = torch.from_numpy(case["y"]), torch.from_numpy(case["g"]).requires_grad_()
    cmap = torch.zeros(2, HW, HW, 1)
    kw = dict(msssim_weights=MSW)
    split = TL.cnet_loss(y, g, cmap, case["vgg"], (29,), perception_target_grad=False,
                         ssim_grad=False, **kw)
    stacked = TL.cnet_loss(y, g, cmap, case["vgg"], (29,), **kw)
    want = jax.jit(_jax_terms(dict(case, w=np.ones(2, np.float32)), True, False,
                              target_grad=False, layers=(29,)))(
        jnp.asarray(case["g"]), jnp.zeros((2, HW, HW, 1)))
    for a, b, c in zip(split, stacked, want):
        np.testing.assert_allclose(float(a.detach()), float(c), rtol=1e-5)
        np.testing.assert_allclose(float(b.detach()), float(c), rtol=1e-5)
    assert split[2].requires_grad and not split[3].requires_grad
    off = TL.cnet_loss(y, g, cmap, case["vgg"], (29,), compute_ssim=False, **kw)
    assert float(off[3]) == 0.0
    np.testing.assert_allclose(float(off[2].detach()), float(stacked[2].detach()), rtol=1e-6)


def test_hard_mask_matches_jax():
    c = np.array([0.0, 0.2, 0.5, 0.5001, 1.0], np.float32)
    np.testing.assert_array_equal(TL.hard_mask(torch.from_numpy(c)).numpy(),
                                  np.asarray(JL.hard_mask(jnp.asarray(c))))
