"""The port's Discriminator against the JAX package's, with the JAX weights
carried across by ``from_jax_variables(..., "discriminator")``: the forward
in eval and in train mode (and the running statistics the train-mode
forward leaves), at the f32 tolerance of ``tests/test_torch_parity.py``; and
a reference-keyed state_dict (the JAX package's ``variables_to_torch``)
loading strictly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcdgan_tpu.io.torch_interop import variables_to_torch
from fcdgan_tpu.models import Discriminator as JaxDiscriminator
from fcdgan_tpu_torch.io.torch_interop import from_jax_variables
from fcdgan_tpu_torch.models.discriminator import Discriminator


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    y = (0.8 * x + rng.normal(scale=0.5, size=x.shape)).astype(np.float32)
    model = JaxDiscriminator(3)
    v = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(y),
                   train=False)
    # non-trivial running statistics, as after some training
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(0.1, 0.5, size=a.shape), a.dtype),
        v["batch_stats"])}
    v = jax.tree.map(np.asarray, v)
    return model, v, x, y


def _port(v, train):
    net = Discriminator(3)
    net.load_state_dict(from_jax_variables(v, "discriminator"), strict=True)
    return net.train(train)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(setup, train):
    model, v, x, y = setup
    net = _port(v, train)
    with torch.no_grad():
        got = net(_nchw(x), _nchw(y))
    assert got.shape == (3,) and got.dtype == torch.float32
    if train:
        want, muts = model.apply(v, jnp.asarray(x), jnp.asarray(y), train=True,
                                 mutable=["batch_stats"])
        want_sd = variables_to_torch(v["params"], muts["batch_stats"], kind="discriminator")
        sd = net.state_dict()
        for k, w in want_sd.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-5, atol=1e-6, err_msg=k)
    else:
        want = model.apply(v, jnp.asarray(x), jnp.asarray(y), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_reference_state_dict_loads_strictly(setup):
    _, v, _, _ = setup
    sd = variables_to_torch(v["params"], v["batch_stats"], kind="discriminator")
    net = Discriminator(3)
    net.load_state_dict({k: torch.as_tensor(np.asarray(a)) for k, a in sd.items()},
                        strict=True)
    assert set(sd) == set(net.state_dict())
    port_sd = from_jax_variables(v, "discriminator")
    for k, a in sd.items():
        np.testing.assert_array_equal(port_sd[k].numpy(), np.asarray(a), err_msg=k)
