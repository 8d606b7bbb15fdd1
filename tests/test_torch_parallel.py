"""The port's data-parallel pieces (``fcdgan_tpu_torch.parallel``) on the CPU.

``pad_batch_to_multiple`` and ``process_slice`` against the JAX package's
over drawn sizes; the collectives' helpers without a process group; the
options' checks; and the cross-rank train-mode BatchNorm on two gloo ranks
against the JAX ``bn_train`` with an ``axis_name`` under ``jax.shard_map``
on two of the eight virtual CPU devices, within the tolerances of
``tests/test_torch_fused_bn.py``."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from fcdgan_tpu.parallel import mesh as jax_mesh
from fcdgan_tpu.parallel import multihost as jax_multihost
from fcdgan_tpu_torch.parallel import mesh
from fcdgan_tpu_torch.parallel.multihost import initialize_multihost, process_slice

import torch_parallel_workers as workers
from torch_ranks import run_ranks


@settings(max_examples=40, deadline=None)
@given(bs=st.integers(1, 23), multiple=st.integers(1, 8), width=st.integers(1, 3))
def test_pad_batch_to_multiple_matches_jax(bs, multiple, width):
    rng = np.random.default_rng(bs * 31 + multiple)
    batch = {"x": rng.normal(size=(bs, width, 2)).astype(np.float32),
             "item": np.arange(bs, dtype=np.int64) * 7,
             "weight": rng.uniform(size=bs).astype(np.float32)}
    got = mesh.pad_batch_to_multiple(batch, multiple)
    want = jax_mesh.pad_batch_to_multiple(batch, multiple)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["weight"]) % multiple == 0


@settings(max_examples=40, deadline=None)
@given(count=st.integers(1, 8), per=st.integers(0, 9), extra=st.integers(0, 7),
       data=st.data())
def test_process_slice_matches_jax(count, per, extra, data):
    from unittest import mock

    index = data.draw(st.integers(0, count - 1))
    n = count * per + (extra % count if count > 1 else 0)
    with mock.patch.object(jax_multihost.jax, "process_count", lambda: count), \
            mock.patch.object(jax_multihost.jax, "process_index", lambda: index):
        if n % count:
            with pytest.raises(ValueError, match="not divisible"):
                jax_multihost.process_slice(n)
            with pytest.raises(ValueError, match="not divisible"):
                process_slice(n, count, index)
            return
        assert process_slice(n, count, index) == jax_multihost.process_slice(n)


def test_helpers_without_a_group_change_nothing():
    """No process group: no collective, whole batches, rank 0 of a world of one."""
    assert not mesh.group_active() and mesh.world() == 1 and mesh.rank() == 0
    assert mesh.writes() and not mesh.multihost()
    t = torch.arange(6.0).view(3, 2)
    assert mesh.all_reduce_sum(t)[0] is t and torch.equal(t, torch.arange(6.0).view(3, 2))
    assert mesh.gather(t) is t
    batch = {"x": np.zeros((3, 2)), "weight": np.ones(3, np.float32)}
    assert mesh.shard_batch(batch) is batch
    assert mesh.lead_share(1.0) == 1.0
    assert process_slice(5) == slice(0, 5)
    assert not mesh.any_rank(False, "cpu")
    assert not initialize_multihost(None, 1, None) and not initialize_multihost("h:1", None, 0)


def test_option_checks():
    """--n-devices below 0, a multi-host world without its address or id, or
    with another device count, raise; a data-parallel run pads its tail."""
    from fcdgan_tpu_torch.config import USSSConfig, batch_tail, check_training_options

    for kw, match in ((dict(n_devices=-1), "n-devices"),
                      (dict(num_processes=2, process_id=0), "coordinator-address"),
                      (dict(num_processes=2, coordinator_address="h:1"), "process-id"),
                      (dict(num_processes=2, process_id=0, coordinator_address="h:1",
                            n_devices=4), "one device per process")):
        with pytest.raises(ValueError, match=match):
            check_training_options(USSSConfig(**kw))
    with pytest.raises(ValueError, match="process-id"):
        initialize_multihost("localhost:1", 2, None, "cpu")
    cfg = USSSConfig()
    assert batch_tail(cfg) == "short"
    assert batch_tail(dataclasses.replace(cfg, n_devices=1)) == "pad"
    assert batch_tail(dataclasses.replace(cfg, num_processes=2)) == "pad"
    assert batch_tail(dataclasses.replace(cfg, n_devices=2, tail="short")) == "short"


def test_launch_needs_its_devices():
    """Fewer GPUs than ranks raises, as make_mesh does; nothing falls back."""
    with pytest.raises(ValueError, match=f"need 2 devices, have {torch.cuda.device_count()}"):
        mesh.launch(print, 2, "cuda")
    with pytest.raises(ValueError, match="at least 1"):
        mesh.launch(print, 0, "cpu")


def _jax_bn(x, scale, bias, dy):
    """JAX ``bn_train`` with ``axis_name`` on two virtual devices: y, mean,
    var, dx and the (psum'ed) dscale and dbias."""
    from jax.sharding import Mesh, PartitionSpec as P

    from fcdgan_tpu.ops.fused_bn import bn_train

    jmesh = Mesh(np.array(jax.devices()[:2]), ("dp",))

    def local(xs, dys):
        def f(x_, s_, b_):
            return bn_train(x_, s_, b_, 1, 1e-5, "dp", jnp.float32)

        (y, m, v), vjp = jax.vjp(f, xs, jnp.asarray(scale), jnp.asarray(bias))
        dx, ds, db = vjp((dys, jnp.zeros_like(m), jnp.zeros_like(v)))
        return y, m[None], v[None], dx, ds[None], db[None]

    outs = jax.jit(jax.shard_map(local, mesh=jmesh, in_specs=(P("dp"), P("dp")),
                                 out_specs=(P("dp"),) * 6))(jnp.asarray(x), jnp.asarray(dy))
    y, m, v, dx, ds, db = map(np.asarray, outs)
    return dict(y=y, mean=m[0], var=v[0], dx=dx, dscale=ds[0], dbias=db[0])


def test_bn_train_on_two_ranks_matches_jax_axis_name(tmp_path):
    """Each rank's slice through the port's ``bn_train`` (the kernels' plain
    versions) with the sums all-reduced: y and dx of the slices, the global
    mean and var on both ranks, and the ranks' parts of dscale and dbias
    summing to the JAX gradients."""
    rng = np.random.default_rng(7)
    shape = (4, 6, 10, 8)
    x = rng.normal(0.3, 1.5, size=shape).astype(np.float32)
    scale = (rng.normal(size=8) ** 2 + 0.5).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    nchw = lambda a: np.ascontiguousarray(a.transpose(0, 3, 1, 2))  # noqa: E731
    ranks = run_ranks(workers.bn_train, (nchw(x), scale, bias, nchw(dy)), tmp_path)
    want = _jax_bn(x, scale, bias, dy)
    got_y = np.concatenate([r["y"] for r in ranks]).transpose(0, 2, 3, 1)
    got_dx = np.concatenate([r["dx"] for r in ranks]).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got_y, want["y"], rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], want["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["var"], want["var"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["mean"], ranks[1]["mean"])
    np.testing.assert_array_equal(ranks[0]["var"], ranks[1]["var"])
    for got, name in ((got_dx, "dx"), (sum(r["dscale"] for r in ranks), "dscale"),
                      (sum(r["dbias"] for r in ranks), "dbias")):
        np.testing.assert_allclose(got, want[name], rtol=2e-4, atol=2e-5, err_msg=name)
