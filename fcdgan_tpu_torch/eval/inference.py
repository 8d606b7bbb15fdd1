"""Stitched full-scene inference, fused path (JAX ``eval/inference.py``).

``stitched_inference`` keeps the scene pair resident on the device, runs
the eval Segmentor over every tile in batch-exact chunks, stitches the tile
interiors into one device canvas, downloads it once and writes the density
raster. The per-batch streaming path of the JAX package is not ported.
"""

from __future__ import annotations

import time

import torch

from ..data.device_cache import DeviceSceneCache


def stitched_inference(dataset, model, batch_size: int, device) -> dict:
    """Density of ``dataset``'s scene through ``model`` (eval, on ``device``),
    written via ``dataset.write_full``. Returns {"density", "pixels",
    "seconds", "px_per_s"}; as in the JAX package, seconds start after the
    scene upload and span the device pass, the download and the raster
    write."""
    device = torch.device(device)
    cache = DeviceSceneCache(dataset, dataset.enhance, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    density = cache.stitched_density(model, batch_size=batch_size)
    dataset.write_full(density)
    seconds = time.perf_counter() - t0
    pixels = int(density.size)
    return {"density": density, "pixels": pixels, "seconds": seconds,
            "px_per_s": pixels / max(seconds, 1e-9)}
