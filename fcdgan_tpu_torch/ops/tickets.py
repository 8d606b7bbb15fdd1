"""The stream, ticket counters and SM count of a one-launch reduction kernel.

``csrc/channel_sums.cu`` and ``csrc/fused_ssim.cu`` finish in the launch that
computes the partial sums: each block draws a ticket from an unsigned int
counter and the block that draws the last one adds the partials and sets the
counter back to 0. The counter must be 0 when a launch starts and must not be
shared by two launches in flight. Launches on one stream run one after
another, so each (device, stream) gets one array of ``MAX_TICKETS``
counters (a kernel may use one per group of its blocks), zeroed once when it
is allocated (that one fill is the only launch besides the kernels'); kernels
on two streams never share one.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

MAX_TICKETS = 1024  # counters per stream (kMaxTickets)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def stream_and_counter(device: torch.device) -> Tuple[int, int]:
    """(current stream handle, address of its ticket counters) on ``device``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    counter = _COUNTERS.get((device.index, stream))
    if counter is None:
        with torch.cuda.device(device):
            counter = torch.zeros(MAX_TICKETS, dtype=torch.int32, device=device)
        _COUNTERS[(device.index, stream)] = counter
    return stream, counter.data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the grid caps)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
