"""Data parallelism over a world of ranks, one process per device.

Counterpart of the JAX package's ``parallel/mesh.py``. There a 1-D
``data`` mesh shards each batch on its batch axis, replicates the
parameters, and GSPMD inserts the collectives. PyTorch's idiom is one
process per device, so the port makes each collective explicit. The step
functions stay the single-device functions, with the same global-batch
semantics:

  * ``launch`` runs a function on N local ranks (``--n-devices N``): rank r
    on ``cuda:r`` over NCCL, or N gloo ranks on the CPU. It raises when
    fewer than N GPUs exist. A world of one runs in the calling process;
    larger worlds are spawned, and a rank that fails stops every rank.
  * ``pad_batch_to_multiple`` (a copy of the JAX one) wrap-pads the global
    host batch with weight-0 duplicates to a multiple of the world, and
    ``shard_batch`` keeps this rank's contiguous slice of it.
  * Every collective is a SUM ``all_reduce`` (``collective_calls`` counts
    them, the counterpart of the JAX count of ``all-reduce`` ops in a
    step's HLO). ``all_reduce_sum`` serves the
    BatchNorm statistics (``ops/fused_bn``), the global weight sums
    (``ops/losses``), the metrics and the confusion matrix;
    ``all_reduce_grads`` sums the gradients in buckets before each
    optimizer step. ``gather`` concatenates the rank slices of an output
    as an all-reduce into a zeroed buffer of the full batch, because gloo
    takes CUDA tensors for ``all_reduce`` but not for ``all_gather``.

Without a process group every helper is a no-op and no collective runs.
Inside ``replicated()`` every rank computes the whole batch and the
collectives are off: the JAX ``shard_batch`` replicates a batch that does
not divide the mesh.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.pipeline import Batch

# the gradient bytes one all-reduce carries at most (DistributedDataParallel's
# default bucket is 25 MB; the nets here hold a few million parameters)
BUCKET_BYTES = 64 << 20

_state = {"replicated": 0, "multihost": False, "calls": 0}


def group_active() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def active() -> bool:
    """Whether collectives run: a process group, outside ``replicated()``."""
    return group_active() and not _state["replicated"]


def world() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if group_active() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if group_active() else 0


def multihost() -> bool:
    """Whether the world is a multi-host one (``parallel.multihost``)."""
    return group_active() and _state["multihost"]


def writes() -> bool:
    """Whether this process writes the run's artifacts: every process of a
    multi-host world (each into its own directory, as in the JAX package),
    rank 0 of local ranks, and a process without a group."""
    return not group_active() or _state["multihost"] or rank() == 0


@contextlib.contextmanager
def replicated() -> Iterator[None]:
    """Within the block every rank computes whole batches: no collective
    runs and ``lead_share`` gives every rank the whole constant."""
    _state["replicated"] += 1
    try:
        yield
    finally:
        _state["replicated"] -= 1


def collective_calls() -> int:
    """The all-reduce calls this process has made so far."""
    return _state["calls"]


def _all_reduce(t: torch.Tensor) -> None:
    _state["calls"] += 1
    dist.all_reduce(t)


def lead_share(c: float) -> float:
    """This rank's part of a constant term ``c`` of a loss that is summed over
    the ranks: all of it on rank 0 (and without collectives), none elsewhere."""
    return c if not active() or rank() == 0 else 0.0


def all_reduce_sum(*tensors: torch.Tensor):
    """Sum each tensor over the ranks, in place, in one all-reduce of their
    concatenation (one dtype); returns the tensors. A no-op without
    collectives."""
    if not active() or not tensors:
        return tensors
    if len(tensors) == 1 and tensors[0].is_contiguous():
        _all_reduce(tensors[0])
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tensors


def all_reduce_grads(params, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum the gradients of ``params`` over the ranks before an optimizer
    step: each rank holds the gradient of its partial loss (its samples over
    the global weight sum), so the sum is the global batch's gradient. The
    gradients go in buckets of at most ``bucket_bytes``."""
    if not active():
        return
    bucket, size = [], 0
    for p in params:
        if p.grad is None:
            continue
        bucket.append(p.grad)
        size += p.grad.numel() * p.grad.element_size()
        if size >= bucket_bytes:
            all_reduce_sum(*bucket)
            bucket, size = [], 0
    if bucket:
        all_reduce_sum(*bucket)


def gather(t: torch.Tensor) -> torch.Tensor:
    """The rank slices of a batch-sharded tensor concatenated in rank order,
    on every rank: an all-reduce of a zeroed buffer of the full batch into
    which each rank wrote its slice. ``t`` itself without collectives."""
    if not active():
        return t
    b = t.shape[0]
    out = t.new_zeros((world() * b,) + tuple(t.shape[1:]))
    out[rank() * b:(rank() + 1) * b] = t
    _all_reduce(out)
    return out


def split_apply(fn: Callable, batch: dict):
    """``fn(batch)``, a batch-major tensor, placed as the JAX ``shard_batch``
    places a serving batch: when the batch divides the world each rank
    applies ``fn`` to its contiguous slice and the outputs are gathered to
    every rank; otherwise every rank applies it to the whole batch with the
    collectives off. ``fn(batch)`` without a group."""
    if not active():
        return fn(batch)
    bs = len(batch["weight"])
    if bs % world():
        with replicated():
            return fn(batch)
    return gather(fn(_rank_rows(batch, bs)))


def any_rank(flag: bool, device) -> bool:
    """Whether ``flag`` holds on any rank (``flag`` without collectives)."""
    if not active():
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    _all_reduce(t)
    return bool(t.item() > 0)


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if group_active():
        dist.barrier()


@contextlib.contextmanager
def lead_first() -> Iterator[None]:
    """Rank 0 runs the block first and the other ranks after it: a cache
    file that the block writes when it is missing (the statistics caches)
    is written once and read by the others."""
    if not group_active():
        yield
        return
    if rank() != 0:
        dist.barrier()
    yield
    if rank() == 0:
        dist.barrier()


def pad_batch_to_multiple(batch: dict, multiple: int) -> dict:
    """Wrap-pad every batch-axis field with weight-0 duplicates so that the
    batch divides ``multiple`` (JAX mesh.py:73-91). Fields whose leading
    axis is not the batch's (a window batch's ``slab``) are kept."""
    w = np.asarray(batch["weight"])
    bs = len(w)
    rem = bs % multiple
    if rem == 0:
        return batch
    extra = multiple - rem
    reps = np.resize(np.arange(bs), extra)
    out = Batch()
    for k, v in batch.items():
        if np.ndim(v) >= 1 and np.shape(v)[0] == bs:
            v = np.asarray(v)
            out[k] = np.concatenate([v, v[reps]], axis=0)
        else:
            out[k] = v
    out["weight"] = np.concatenate([w, np.zeros(extra, np.float32)])
    return out


def rank_slice(n: int, count: Optional[int] = None, index: Optional[int] = None) -> slice:
    """Rank ``index``'s contiguous slice of a batch axis of length ``n``
    split over ``count`` ranks (default: this world and rank)."""
    k = world() if count is None else count
    i = rank() if index is None else index
    if n % k:
        raise ValueError(f"global batch {n} not divisible by {k} processes")
    per = n // k
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: dict) -> dict:
    """This rank's slice of a global host batch: wrap-padded to a multiple
    of the world, then cut (every rank holds the same global batch, from
    the same seeded order). The batch as it is without collectives."""
    if not active():
        return batch
    batch = pad_batch_to_multiple(batch, world())
    return _rank_rows(batch, len(batch["weight"]))


def _rank_rows(batch: dict, bs: int) -> dict:
    """This rank's rows of every field whose leading axis is the batch's
    (``bs``, a multiple of the world); other fields as they are."""
    sl = rank_slice(bs)
    return Batch({k: (v[sl] if np.ndim(v) >= 1 and np.shape(v)[0] == bs else v)
                  for k, v in batch.items()})


def join(index: int, size: int, init_method: str, device: torch.device,
         backend: Optional[str] = None) -> None:
    """Start this process's group as rank ``index`` of ``size``: NCCL on a
    CUDA device (made the current one), gloo on the CPU, unless ``backend``
    says otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=index,
                            device_id=device if backend == "nccl" else None)


@contextlib.contextmanager
def world_group(index: int, size: int, init_method: str, device: torch.device,
                backend: Optional[str] = None) -> Iterator[None]:
    """``join`` for the block; the group is destroyed however it ends."""
    join(index, size, init_method, device, backend)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(index: int, fn: Callable, args: tuple, size: int, device: str, store: str,
               threads: int) -> None:
    """The body of a spawned rank: its device, its group, ``fn(*args)``;
    rank 0's result saved for the parent. Ranks past 0 print nothing."""
    torch.set_num_threads(threads)
    if index:
        sys.stdout = open(os.devnull, "w")
    dev = torch.device("cuda", index) if torch.device(device).type == "cuda" \
        else torch.device("cpu")
    with world_group(index, size, "file://" + os.path.join(store, "rendezvous"), dev):
        out = fn(*args)
        if index == 0:
            tmp = os.path.join(store, "result.tmp")
            torch.save(out, tmp)
            os.replace(tmp, os.path.join(store, "result.pt"))


def launch(fn: Callable, n: int, device: str, *args):
    """``fn(*args)`` on ``n`` ranks, one process per device, and rank 0's
    result: rank r on ``cuda:r`` over NCCL (``device`` cuda), or gloo ranks
    on the CPU (``device`` cpu). Raises when fewer than ``n`` GPUs exist.
    A world of one runs here; a larger one is spawned (``fn`` must be a
    module-level function), and when a rank fails the others are stopped
    and the error is raised here. The ranks meet through a file store in a
    temporary directory, so no port is taken."""
    from ..utils.device import resolve_device

    if n < 1:
        raise ValueError(f"--n-devices must be at least 1, not {n}")
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"need {n} devices, have {have}")
    else:
        resolve_device(device)
    store = tempfile.mkdtemp(prefix="fcdgan_world_")
    try:
        if n == 1:
            first = torch.device("cuda", 0) if dev.type == "cuda" else dev
            with world_group(0, 1, "file://" + os.path.join(store, "rendezvous"), first):
                return fn(*args)
        import torch.multiprocessing as mp

        threads = torch.get_num_threads()
        if dev.type == "cpu":
            threads = max(1, threads // n)
        mp.start_processes(_rank_main, args=(fn, args, n, device, store, threads), nprocs=n,
                           join=True, start_method="spawn")
        return torch.load(os.path.join(store, "result.pt"), weights_only=False)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def run_world(fn: Callable, cfg):
    """``fn(cfg)`` in the world that the config's options ask for: a
    multi-host world when ``num_processes`` > 1 (``parallel.multihost``),
    ``n_devices`` local ranks when it is set, else this process alone, with
    no process group."""
    from ..config import asks_multihost
    from .multihost import multihost_world

    if asks_multihost(cfg):
        with multihost_world(cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                             cfg.device):
            return fn(cfg)
    if cfg.n_devices:
        return launch(fn, cfg.n_devices, cfg.device, cfg)
    return fn(cfg)
