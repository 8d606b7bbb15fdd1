"""The stream, ticket counters and SM count of a one-launch reduction kernel.

``csrc/channel_sums.cu`` and ``csrc/fused_ssim.cu`` finish in the launch that
computes the partial sums: each block draws a ticket from an unsigned int
counter and the block that draws the last one adds the partials and sets the
counter back to 0. The counter must be 0 when a launch starts and must not be
shared by two launches in flight. Launches on one stream run one after
another, so each (device, stream) gets one array of counters (a kernel uses
one per group of its blocks: channel_sums one per channel tile, fused_ssim
one per image), zeroed when it is allocated (that fill is the only launch
besides the kernels'); kernels on two streams never share one. The array
starts at ``MAX_TICKETS`` counters and is replaced by a larger zeroed one when
a call needs more (``counter_size``). The old one is kept, not freed: a CUDA
graph captured on the stream holds its address for as long as it replays.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import torch

MAX_TICKETS = 1024  # counters a stream's array starts with (channel_sums' kMaxTickets)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}
_REPLACED: List[torch.Tensor] = []


def counter_size(have: int, need: int) -> int:
    """Counters of a stream's array after a call that needs ``need`` of them:
    ``have`` when that is enough, else the next power of two at or above
    ``need`` and ``MAX_TICKETS``."""
    if need <= have:
        return have
    return 1 << (max(need, MAX_TICKETS) - 1).bit_length()


def counters(table: Dict, key, need: int, zeros: Callable[[int], torch.Tensor]
             ) -> torch.Tensor:
    """The counter array of ``key`` in ``table``, made or replaced by
    ``zeros(size)`` when it holds fewer than ``need`` (the replaced one is
    kept alive)."""
    counter = table.get(key)
    have = 0 if counter is None else counter.numel()
    size = counter_size(have, need)
    if size > have:
        if counter is not None:
            _REPLACED.append(counter)
        counter = table[key] = zeros(size)
    return counter


def stream_and_counter(device: torch.device, need: int = MAX_TICKETS) -> Tuple[int, int]:
    """(current stream handle, address of its ticket counters) on ``device``,
    with at least ``need`` counters."""
    stream = torch.cuda.current_stream(device).cuda_stream

    def zeros(size: int) -> torch.Tensor:
        with torch.cuda.device(device):
            return torch.zeros(size, dtype=torch.int32, device=device)

    return stream, counters(_COUNTERS, (device.index, stream), need, zeros).data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the grid caps)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
