"""Stitched full-scene inference: the fused resident path and the streaming
path, whose device compute overlaps the host's writes.

Port of the JAX package's ``eval/inference.py`` (:27-307) on one device:

  * ``cropped_infer`` trims each tile's overlap halo on the device before
    the download (the stitched writes read the interior only).
  * ``quantized_infer`` returns ``(fn, dequant)``: ``fn`` gives the density
    in its download type (``utils.download``: float32, uint8 or bfloat16),
    ``dequant`` turns a downloaded one back into a float32 array.
  * ``run_overlapped`` runs ``compute`` on the caller's thread and
    ``process`` on a writer thread behind a bounded queue.
  * ``stitched_inference`` serves one ``ScenePairDataset`` through the JAX
    feed choice (:195-270): ``auto`` runs the fused pass of the resident
    scene (``DeviceSceneCache``) or, past its budget, of the rolling window
    (``DeviceSceneWindowCache``); ``cache`` gathers batches from the
    resident scene; otherwise (and when neither cache takes the scene) host
    tiles stream from the native loader, raw and normalized on the device
    by ``DeviceNormalizer`` when it can, else float32, or from the Python
    ``BatchLoader`` (``use_native=False``, or no native library). The
    result names the ``feed``: resident, window, native_raw, native, host.

Models here are NHWC functions ``infer(x, y) -> (B, h, w, 1)`` float32
(``nhwc_infer`` wraps the NCHW Segmentor).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import native
from ..data.device_cache import DeviceSceneCache, DeviceSceneWindowCache
from ..data.pipeline import (BatchLoader, DeviceNormalizer, NativeSceneBatchLoader,
                             device_put_batch, prefetch, upload)
from ..utils.download import Download, check_density_dtype, dequantize, quantize


def nhwc_infer(model) -> Callable:
    """The NCHW Segmentor as an NHWC ``infer(x, y)`` -> (B, H, W, 1)."""
    def infer(x, y):
        return model(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    return infer


def cropped_infer(infer: Callable, overlap_padding, patch_size) -> Callable:
    """``infer`` with each tile's halo cut on the device (JAX
    inference.py:27-57): (B, ph - 2 pady, pw - 2 padx, 1), the shape that
    ``ScenePairDataset.write`` recognises as already cropped."""
    padx, pady = overlap_padding
    pw, ph = patch_size
    if padx == 0 and pady == 0:
        return infer

    def crop(x, y):
        return infer(x, y)[:, pady:ph - pady, padx:pw - padx]

    return crop


def quantized_infer(infer: Callable, density_dtype: str = "float32"):
    """``(fn, dequant)`` (JAX inference.py:60-97): ``fn`` quantizes the
    density on the device for its download, ``dequant(t)`` gives the float32
    host array of a downloaded (or device) result."""
    check_density_dtype(density_dtype)

    def dequant(t: torch.Tensor) -> np.ndarray:
        return dequantize(t.cpu(), density_dtype)

    if density_dtype == "float32":
        return infer, dequant
    return (lambda x, y: quantize(infer(x, y), density_dtype)), dequant


def run_overlapped(batches, compute: Callable, process: Callable, depth: int = 4) -> None:
    """Overlap device compute with per-batch host work (JAX
    inference.py:99-160, without its multi-host branch).

    ``compute(batch)`` runs on the caller's thread and queues device work;
    ``process(out, batch)`` runs on a writer thread, behind a queue of at
    most ``depth`` batches. PyTorch's current CUDA stream is per thread, so
    ``compute`` hands over ``utils.download.Download`` objects, whose
    ``result()`` waits on an event recorded behind the copy, never a device
    tensor that the producer's stream may still be writing. An error in
    ``process`` stops the producer at its next batch, the queued jobs are
    drained unprocessed, and the error is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err = []

    def writer():
        while True:
            job = q.get()
            if job is sentinel:
                return
            if not err:
                try:
                    process(*job)
                except BaseException as e:  # re-raised on the caller's thread
                    err.append(e)

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        for batch in batches:
            if err:  # no device time for batches nobody will process
                break
            q.put((compute(batch), batch))
    finally:
        q.put(sentinel)
        wt.join()
    if err:
        raise err[0]


_TRANSFER = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def transfer_type(name: str) -> Optional[torch.dtype]:
    """The upload type of ``--transfer-dtype`` (``""``: as the loader gives)."""
    if not name:
        return None
    if name not in _TRANSFER:
        raise ValueError(f"transfer_dtype must be one of {sorted(_TRANSFER)} or empty, "
                         f"not {name!r}")
    return _TRANSFER[name]


@torch.no_grad()
def stitched_inference(dataset, model, batch_size: int, device, device_feed: str = "auto",
                       density_dtype: str = "float32",
                       transfer_dtype: Optional[torch.dtype] = None,
                       prefetch_depth: int = 2, writer_depth: int = 4,
                       on_tile: Optional[Callable[[int, np.ndarray], None]] = None,
                       use_native: bool = True) -> dict:
    """Density of ``dataset``'s scene through the eval-mode ``model`` on
    ``device``, written through the dataset's density raster (JAX
    inference.py:163-307).

    Returns {"density", "pixels", "seconds", "px_per_s", "fused", "feed"}:
    ``density`` is the whole float32 raster on the fused paths and None on
    the others. ``transfer_dtype`` is the upload type of streamed host
    tiles (the JAX tool's ``--transfer-dtype``, inference.py:263-268); the
    resident feeds upload the raw scene once. On the per-batch paths
    ``on_tile(item, d)``, when given,
    gets each real tile's (core_h, core_w) float32 interior on the writer
    thread. As in the JAX package the fused seconds start after the scene
    upload; the per-batch ones span the whole pass."""
    if device_feed not in ("auto", "cache", "stream"):
        raise ValueError(f"device_feed must be auto, cache or stream, not {device_feed!r}")
    device = torch.device(device)
    cache = None
    if device_feed == "auto":
        if DeviceSceneCache.supports(dataset):
            cache, feed = DeviceSceneCache(dataset, dataset.enhance, device), "resident"
        elif DeviceSceneWindowCache.supports(dataset):
            # past the resident budget: per-slab fused passes (the window)
            cache, feed = DeviceSceneWindowCache(dataset, dataset.enhance, device), "window"
    if cache is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        density = cache.stitched_density(model, batch_size, density_dtype)
        dataset.write_full(density)
        dataset.close_outputs()
        seconds = time.perf_counter() - t0
        return {"density": density, "pixels": int(density.size), "seconds": seconds,
                "px_per_s": density.size / max(seconds, 1e-9), "fused": True, "feed": feed}

    infer, dequant = quantized_infer(
        cropped_infer(nhwc_infer(model), dataset.overlap_padding, dataset.patch_size),
        density_dtype)
    normalizer = None
    if device_feed != "stream" and DeviceSceneCache.supports(dataset):
        cache, feed = DeviceSceneCache(dataset, dataset.enhance, device), "resident"
        loader = cache.loader(batch_size)
    elif use_native and all(native.can_open(r.path)
                            for r in (dataset.raster_x, dataset.raster_y)):
        raw = (transfer_dtype is None
               and NativeSceneBatchLoader.supports_device_normalize(dataset))
        loader = NativeSceneBatchLoader(dataset, batch_size, device_normalize=raw)
        feed = "native_raw" if raw else "native"
        if raw:
            normalizer = DeviceNormalizer(dataset.enhance, dataset.raster_x.nband, device)
    else:
        loader = BatchLoader(dataset, batch_size, fields=("x", "y", "item"), shuffle=False)
        feed = "host"
    interior = dataset.interior_sizes()
    pixels = 0
    t0 = time.perf_counter()

    def compute(batch):
        nonlocal pixels
        if cache is not None:
            db = cache.complete(batch)
            bx, by = db["x"], db["y"]
        elif normalizer is not None:  # raw tiles, normalized on the device
            db = normalizer(device_put_batch({k: batch[k] for k in ("x", "y", "ref", "win")},
                                             device))
            bx, by = db["x"], db["y"]
        else:
            bx = upload(batch["x"], device, transfer_dtype)
            by = upload(batch["y"], device, transfer_dtype)
        pixels += int(sum(np.prod(interior[int(i)]) for i, w in
                          zip(batch["item"], batch["weight"]) if w > 0))
        return Download(infer(bx, by))

    def process(dl: Download, batch):
        cmap = dequant(dl.result())
        for ns, (item, w) in enumerate(zip(batch["item"], batch["weight"])):
            if w == 0:
                continue
            dataset.write_default(cmap[ns], int(item))
            if on_tile is not None:
                ch, cw = interior[int(item)]
                on_tile(int(item), cmap[ns, :ch, :cw, 0])

    run_overlapped(prefetch(iter(loader), prefetch_depth), compute, process,
                   depth=writer_depth)
    seconds = time.perf_counter() - t0
    dataset.close_outputs()
    return {"density": None, "pixels": pixels, "seconds": seconds,
            "px_per_s": pixels / max(seconds, 1e-9), "fused": False, "feed": feed}
