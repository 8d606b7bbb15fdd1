"""Rank bodies of the data-parallel tests (``torch_ranks.run_ranks``).

Each function runs on one rank of a gloo world and returns numpy arrays.
The module imports torch and the port only, so a spawned rank starts
without JAX."""

import numpy as np
import torch

from fcdgan_tpu_torch.parallel import mesh


def _np(t):
    return t.detach().cpu().numpy().copy()


def _rows(a, rank, world):
    n = len(a) // world
    return a[rank * n:(rank + 1) * n]


def bn_train(rank, x, scale, bias, dy):
    """``ops.fused_bn.bn_train`` on this rank's slice of (x, dy): y, mean,
    var, dx of the slice and the (global) dscale and dbias."""
    from fcdgan_tpu_torch.ops.fused_bn import bn_train as bn

    w = mesh.world()
    xt = torch.from_numpy(_rows(x, rank, w)).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y, mean, var = bn(xt, st, bt, 1e-5)
    y.backward(torch.from_numpy(_rows(dy, rank, w)))
    return dict(y=_np(y), mean=_np(mean), var=_np(var), dx=_np(xt.grad),
                dscale=_np(st.grad), dbias=_np(bt.grad))


def _state(nets):
    return {n: {k: _np(v) for k, v in net.state_dict().items()} for n, net in nets.items()}


def _grads(nets):
    return {n: {k: _np(p.grad) for k, p in net.named_parameters() if p.grad is not None}
            for n, net in nets.items()}


def _vgg():
    """The fixed-seed random VGG16 (the JAX ``vgg16_random_params(0)``)."""
    from fcdgan_tpu_torch.models.vgg import VGG16Weights, load_vgg16_params

    return VGG16Weights(load_vgg16_params(None), "cpu")


def usss_step(rank, phase, state, taps, batch, interior, pad, msw):
    """One ``USSSSteps`` step of ``phase`` on this rank's slice of ``batch``,
    from the state dicts ``state``: metrics, state and the summed gradients."""
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.train.optim import adam
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, USSSSteps

    nets = {"g": Generator(3), "s": Segmentor(3)}
    for n, net in nets.items():
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state[n].items()})
    g, s = nets["g"], nets["s"]
    steps = USSSSteps(g, s, adam(g.parameters()), adam(s.parameters()), _vgg(),
                      PerceptionConfig(taps, True), 0.4, 0.65, 0.0, interior, pad,
                      msssim_weights=msw)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in mesh.shard_batch(batch).items()}
    t["item"] = t["item"].long()
    if phase == "g_pretrain":
        m = steps.g_pretrain(t["x"], t["y"], t["weight"], 1e-4)
    elif phase == "s_init":
        m = steps.s_init(t["x"], t["y"], t["ref"], t["item"], t["weight"], 1e-4)
    else:
        m = steps.joint(t["x"], t["y"], t["ref"], t["item"], t["weight"], 1e-4, 1e-4)
    return dict(metrics={k: _np(v) for k, v in m.items()}, state=_state(nets),
                grads=_grads(nets))


def adversarial_step(rank, mode, state, batch, interior, pad):
    """One WSSS or RSSS adversarial step (``mode``) on this rank's slice of
    the padded ``batch`` (the whole batch without a group), from ``state``:
    metrics, state and summed gradients. Rank None runs it in this process."""
    from fcdgan_tpu_torch.models.discriminator import Discriminator
    from fcdgan_tpu_torch.models.generator import Generator
    from fcdgan_tpu_torch.models.segmentor import Segmentor
    from fcdgan_tpu_torch.train.optim import adam, rmsprop
    from fcdgan_tpu_torch.train.steps import PerceptionConfig, RSSSSteps, WSSSSteps

    nb = (batch["c_x"] if mode == "wsss" else batch["x"]).shape[-1]
    nets = {"g": Generator(nb), "s": Segmentor(nb), "d": Discriminator(nb)}
    for n, net in nets.items():
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state[n].items()})
    g, s, d = nets["g"], nets["s"], nets["d"]
    opts = adam(g.parameters()), rmsprop(s.parameters()), rmsprop(d.parameters())
    vgg = _vgg()
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in mesh.shard_batch(batch).items()}
    if mode == "wsss":
        steps = WSSSSteps(g, s, d, *opts, vgg, PerceptionConfig((3,), False), 0.5, 0.0,
                          0.2, 1.6, 1.0, 1.5, prob_thresh=0.6, msssim_weights=(0.5, 0.5))
        m = steps.adversarial(t["c_x"], t["c_y"], t["c_ref"], t["nc_x"], t["nc_y"],
                              t["weight"], 1e-4, 5e-5)
    else:
        steps = RSSSSteps(g, s, d, *opts, vgg, PerceptionConfig((3,), True), 0.1, 0.0,
                          0.5, 0.02, 1.0, 2.0, interior, pad, msssim_weights=(0.5, 0.5))
        m = steps.adversarial(t["x"], t["y"], t["ref"], t["region"], t["item"].long(),
                              t["weight"], 1e-4, 5e-5)
    return dict(metrics={k: _np(v) for k, v in m.items()}, state=_state(nets),
                grads=_grads(nets))


def adversarial_steps(rank, cases):
    """``adversarial_step`` of each mode of ``cases`` ({mode: (state, batch,
    interior, pad)}), in one world."""
    return {mode: adversarial_step(rank, mode, *case) for mode, case in cases.items()}


def nan_checked_step(rank):
    """``train.loops.nan_checked`` around a step whose loss is NaN on rank 0
    only and whose gradients are finite: the message each rank raised, or
    None."""
    from fcdgan_tpu_torch.train.loops import nan_checked

    net = torch.nn.Linear(2, 1)

    def step():
        loss = net(torch.ones(1, 2)).sum()
        loss.backward()
        bad = float("nan") if rank == 0 else 0.0
        return {"NetLoss": loss.detach() + bad}

    try:
        nan_checked(step, "joint", 0, net)
    except FloatingPointError as e:
        return str(e)
    return None


def fail_on_rank_one():
    """Rank 1 raises an I/O error while rank 0 waits in an all-reduce."""
    if mesh.rank() == 1:
        raise OSError("rank 1 cannot read its tiles")
    mesh.all_reduce_sum(torch.ones(1))
    return "rank 0 was not stopped"
