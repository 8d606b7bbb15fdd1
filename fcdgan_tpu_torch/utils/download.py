"""Device-to-host density downloads: the quantized formats and pinned copies.

The JAX package quantizes a density on the device before its download
(``eval/inference.quantized_infer``, :60-97, and the fused ``run`` body,
``data/device_cache.py``:147-153): ``uint8`` is ``clip(d, 0, 1) * 255 +
0.5`` truncated (a dequantization error of at most 1/510 on [0, 1]),
``bfloat16`` a round-to-nearest-even cast, ``float32`` the density as it
is. The clamp comes before the scale, so every value is at least 0.5 and
the truncation of ``.to(torch.uint8)`` rounds as JAX's ``astype`` does.

``Download`` copies a CUDA tensor into pinned host memory with a
``non_blocking`` copy on the device's current stream and records an event
behind it, so the caller's thread goes on queueing work while the copy runs;
``result()``, on any thread, waits on that event. The pinned buffer lives as
long as the ``Download``. A CPU tensor is its own result.
"""

from __future__ import annotations

import numpy as np
import torch

DENSITY_DTYPES = ("float32", "uint8", "bfloat16")


def check_density_dtype(density_dtype: str) -> None:
    if density_dtype not in DENSITY_DTYPES:
        raise ValueError(f"density_dtype must be one of {DENSITY_DTYPES}, "
                         f"not {density_dtype!r}")


def quantize(d: torch.Tensor, density_dtype: str) -> torch.Tensor:
    """A float32 density in its download format."""
    check_density_dtype(density_dtype)
    if density_dtype == "uint8":
        return (d.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    if density_dtype == "bfloat16":
        return d.to(torch.bfloat16)
    return d


def dequantize(host: torch.Tensor, density_dtype: str) -> np.ndarray:
    """A downloaded density back to a float32 array."""
    check_density_dtype(density_dtype)
    if density_dtype == "uint8":
        return host.numpy().astype(np.float32) / 255.0
    return host.float().numpy()


class Download:
    """A tensor on its way to the host; ``result()`` waits for it."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type != "cuda":
            self._host = t.detach()
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t.detach(), non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    def result(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host
