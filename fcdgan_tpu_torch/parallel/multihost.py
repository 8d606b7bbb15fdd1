"""Multi-host (multi-process) worlds: one process per host device.

Counterpart of the JAX package's ``parallel/multihost.py``. After
``initialize_multihost`` the process is one rank of a world of
``num_processes`` ranks, each owning one device, and the drivers run
unchanged over ``parallel.mesh``'s collectives. Every process builds the
identical global host batch (the loaders are seeded, so the order is the
same everywhere); ``put_multihost`` pads it and keeps this process's
contiguous ``process_slice``, and ``to_host`` gathers an output to every
process, so that each process writes its full artifact set.

The coordinator address is ``host:port`` (a TCP rendezvous, as JAX's) or
any ``torch.distributed`` init URL (``file:///shared/path``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh


def initialize_multihost(coordinator_address: Optional[str], num_processes: Optional[int],
                         process_id: Optional[int], device: str = "cuda") -> bool:
    """Join the world of ``num_processes`` processes as ``process_id``;
    True when multi-host. A no-op (False) when ``num_processes`` is
    None/0/1, as in JAX (multihost.py:31-56). NCCL on a CUDA ``device``
    (made the current one), gloo on the CPU (``mesh.join``)."""
    if not num_processes or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(
            "multi-host needs --coordinator-address and --process-id "
            f"(got {coordinator_address!r}, {process_id!r})")
    from ..utils.device import resolve_device

    init = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    mesh.join(int(process_id), int(num_processes), init, resolve_device(device))
    mesh._state["multihost"] = True
    return True


def shutdown_multihost() -> None:
    """Leave the world (a no-op outside one)."""
    if mesh.group_active():
        dist.destroy_process_group()
    mesh._state["multihost"] = False


@contextlib.contextmanager
def multihost_world(coordinator_address: Optional[str], num_processes: Optional[int],
                    process_id: Optional[int], device: str = "cuda") -> Iterator[bool]:
    """``initialize_multihost`` for the block, left however it ends."""
    joined = initialize_multihost(coordinator_address, num_processes, process_id, device)
    try:
        yield joined
    finally:
        if joined:
            shutdown_multihost()


# this process's contiguous slice of a global batch axis of length n (JAX
# multihost.py:59-66): the rank's slice, one process per rank
process_slice = mesh.rank_slice


# driver-side placement: the global host batch padded to the world, this
# process's slice kept (JAX multihost.py:69-90); the local ranks' too
put_multihost = mesh.shard_batch


def to_host(t: torch.Tensor) -> np.ndarray:
    """A batch-sharded device output gathered to every process, as a host
    array (JAX multihost.py:93-108). Collective: every process calls it in
    the same order."""
    return mesh.gather(t).cpu().numpy()
