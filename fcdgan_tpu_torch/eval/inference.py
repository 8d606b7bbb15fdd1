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
    Under a process group (``parallel.mesh``) the fused passes are skipped,
    as the JAX ``mesh is None`` condition skips them, and each rank runs
    its slice of each batch (``mesh.split_apply``); the densities are
    gathered to every rank before the writes, which the writing ranks do.

  * ``slice_inference`` serves a WHU slice set (Demo_WSSS.py:387-445)
    through a given Segmentor, in train-mode BN (the reference's) or eval
    mode: the slice reads behind ``prefetch``, the upload, the pass in
    batches, the download, the evaluator and two images a slice (the grey
    density and the eval or color map), written on ``run_overlapped``'s
    writer thread. ``tools/infer.py --mode whu`` serves through its host
    loader; the WSSS driver's final inference through its resident stacks.

Models here are NHWC functions ``infer(x, y) -> (B, h, w, 1)`` float32
(``nhwc_infer`` wraps the NCHW Segmentor).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import native
from .changemap import write_changemap
from .evaluator import Evaluator
from ..data.device_cache import DeviceSceneCache, DeviceSceneWindowCache
from ..data.pipeline import (BatchLoader, DeviceNormalizer, NativeSceneBatchLoader,
                             device_put_batch, prefetch, upload)
from ..data.raster import write_image
from ..parallel import mesh
from ..utils.download import Download, check_density_dtype, dequantize, quantize
from ..utils.timing import count, open_ids, span, within


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
    drained unprocessed, and the error is raised here. Spans that ``process``
    opens nest under the spans open on the caller's thread here
    (``utils.timing.within``)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err = []
    parents = open_ids()

    def writer():
        with within(parents):
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

    Returns {"density", "pixels", "fused", "feed", "seconds", "px_per_s"}:
    ``density`` is the whole float32 raster on the fused paths and None on
    the others. ``transfer_dtype`` is the upload type of streamed host
    tiles (the JAX tool's ``--transfer-dtype``, inference.py:263-268); the
    resident feeds upload the raw scene once. On the per-batch paths
    ``on_tile(item, d)``, when given,
    gets each real tile's (core_h, core_w) float32 interior on the writer
    thread. ``seconds`` spans the whole call, the span ``serve.scene``:
    the scene's read and upload, the pass, the download and the writes (the
    JAX package's fused seconds start after the upload). On the fused paths
    the writes are the span ``serve.write``; the resident one spans its
    read, upload, pass and download too (``DeviceSceneCache``)."""
    if device_feed not in ("auto", "cache", "stream"):
        raise ValueError(f"device_feed must be auto, cache or stream, not {device_feed!r}")
    with span("serve.scene"):
        t0 = time.perf_counter()
        out = _serve(dataset, model, batch_size, torch.device(device), device_feed,
                     density_dtype, transfer_dtype, prefetch_depth, writer_depth, on_tile,
                     use_native)
        seconds = time.perf_counter() - t0
    return dict(out, seconds=seconds, px_per_s=out["pixels"] / max(seconds, 1e-9))


def _serve(dataset, model, batch_size, device, device_feed, density_dtype, transfer_dtype,
           prefetch_depth, writer_depth, on_tile, use_native) -> dict:
    """The body of ``stitched_inference``, without its clock."""
    cache = None
    if device_feed == "auto" and not mesh.group_active():
        if DeviceSceneCache.supports(dataset):
            cache, feed = DeviceSceneCache(dataset, dataset.enhance, device), "resident"
        elif DeviceSceneWindowCache.supports(dataset):
            # past the resident budget: per-slab fused passes (the window)
            cache, feed = DeviceSceneWindowCache(dataset, dataset.enhance, device), "window"
    if cache is not None:
        density = cache.stitched_density(model, batch_size, density_dtype)
        with span("serve.write"):
            dataset.write_full(density)
            dataset.close_outputs()
        return {"density": density, "pixels": int(density.size), "fused": True, "feed": feed}

    infer = cropped_infer(nhwc_infer(model), dataset.overlap_padding, dataset.patch_size)
    _, dequant = quantized_infer(infer, density_dtype)
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

    def forward(batch):
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
        return infer(bx, by)

    def compute(batch):
        nonlocal pixels
        pixels += int(sum(np.prod(interior[int(i)]) for i, w in
                          zip(batch["item"], batch["weight"]) if w > 0))
        return Download(quantize(mesh.split_apply(forward, batch), density_dtype))

    def process(dl: Download, batch):
        if not mesh.writes():
            return
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
    dataset.close_outputs()
    return {"density": None, "pixels": pixels, "fused": False, "feed": feed}


_SLICE_FIELDS = ("x", "y", "ref", "item", "label")


@torch.no_grad()
def slice_inference(dataset, model, batch_size: int, device, out_dir: str,
                    density_dir: Optional[str] = None, train_bn: bool = True,
                    prob_thresh: float = 0.5, write_color: bool = True, batches=None,
                    place: Optional[Callable] = None, ref_of: Optional[Callable] = None,
                    keep_densities: bool = False, prefetch_depth: int = 2,
                    on_written: Optional[Callable[[int], None]] = None) -> dict:
    """The slices of ``dataset`` (a ``WHUDataset``) through the Segmentor
    ``model`` on ``device``: for each slice, the eval map (or color map) as
    ``out_dir/<slice name>`` and, with ``density_dir``, the grey density
    (density * 255) there, as the reference's final inference writes them
    (Demo_WSSS.py:387-445).

    ``train_bn`` runs S in train mode, as the reference does ("train mode
    gets better performance", :389-391): each batch normalizes with its own
    statistics (the ``channel_sums`` kernel on the card), and S's running
    buffers move from batch to batch. Otherwise S runs in eval mode.

    ``batches`` are host batches with ``item`` and ``weight`` (0 on a padded
    duplicate, which is run but not written), by default ``BatchLoader``
    over ``dataset`` in its order, read ahead by ``prefetch``.
    ``place(batch, infer)`` puts a batch on the device and returns
    ``infer(x, y)`` of its rows, (n, H, W, 1) float32, the rows in the
    batch's order; by default it uploads the real slices only in train mode
    (the wrap-padded tail's duplicates would skew the statistics) and every
    row in eval mode, spread over the ranks of a process group by
    ``mesh.split_apply``. ``ref_of(batch, row, item)`` is the (H, W) change
    reference of a slice, by default the batch's ``ref``. ``on_written(n)``
    gets the number of slices written after each batch's writes.

    Returns {"slices", "pixels", "seconds", "evaluator", "densities"}: the
    slices written, their pixels, the seconds of the whole call, the
    evaluator of the thresholded densities against the references, and with
    ``keep_densities`` {item: (H, W) float32 density} as downloaded (else
    None). Spans: ``serve.slices`` (the whole call) and inside it
    ``serve.slices.read`` (the wait for the next batch's reads),
    ``serve.slices.pass`` (placement, upload and the pass's enqueue), and on
    the writer thread ``serve.slices.download`` (the wait for the density
    on the host) and ``serve.slices.write`` (the evaluator and the image
    writes); counters ``serve.slices_written`` and ``serve.write_bytes``
    (the images' bytes)."""
    device = torch.device(device)
    model.train(train_bn)
    infer = nhwc_infer(model)
    if batches is None:
        batches = BatchLoader(dataset, batch_size, fields=_SLICE_FIELDS, shuffle=False)
    if place is None:
        place = _host_slices(device, train_bn)
    if ref_of is None:
        ref_of = _batch_ref
    acc = Evaluator(num_class=2)
    densities = {} if keep_densities else None
    done = pixels = 0

    def compute(batch):
        nonlocal pixels
        with span("serve.slices.pass"):
            d = place(batch, infer)
            pixels += d.shape[1] * d.shape[2] * int((np.asarray(batch["weight"]) > 0).sum())
            return Download(d)

    def process(dl: Download, batch):
        nonlocal done
        if not mesh.writes():
            return
        with span("serve.slices.download"):
            cmap = dl.result().numpy()[..., 0]
        with span("serve.slices.write"):
            cmask = (cmap > prob_thresh).astype(np.int16)
            for ns in range(min(len(cmap), len(batch["weight"]))):
                if batch["weight"][ns] == 0:
                    continue
                item = int(batch["item"][ns])
                ref_mask = ref_of(batch, ns, item).astype(np.int16)
                acc.add_batch_map(ref_mask, cmask[ns])
                name = dataset.get_file_name(item)
                nbytes = 0
                if density_dir:
                    grey = np.uint8(cmap[ns] * 255)
                    write_image(os.path.join(density_dir, name), grey)
                    nbytes += grey.nbytes
                change = write_changemap(cmask[ns], ref_mask, write_color)
                if change.ndim == 3:
                    change = change.transpose((1, 2, 0))
                change = np.uint8(change)
                write_image(os.path.join(out_dir, name), change)
                if densities is not None:
                    densities[item] = cmap[ns]
                done += 1
                count("serve.slices_written")
                count("serve.write_bytes", nbytes + change.nbytes)
        if on_written is not None:
            on_written(done)

    with span("serve.slices"):
        t0 = time.perf_counter()
        run_overlapped(_timed_reads(prefetch(iter(batches), prefetch_depth)), compute,
                       process)
        seconds = time.perf_counter() - t0
    return {"slices": done, "pixels": pixels, "seconds": seconds, "evaluator": acc,
            "densities": densities}


def _timed_reads(batches):
    """``batches``, the wait for each one a ``serve.slices.read`` span."""
    it = iter(batches)
    while True:
        with span("serve.slices.read"):
            b = next(it, None)
        if b is None:
            return
        yield b


def _batch_ref(batch, row: int, item: int) -> np.ndarray:
    return batch["ref"][row][:, :, 0]


def _host_slices(device: torch.device, train_bn: bool) -> Callable:
    """``slice_inference``'s default placement of host batches."""
    def place(batch, infer):
        n = int(batch["weight"].sum()) if train_bn else len(batch["weight"])
        return mesh.split_apply(
            lambda b: infer(upload(np.ascontiguousarray(b["x"]), device),
                            upload(np.ascontiguousarray(b["y"]), device)),
            {k: batch[k][:n] for k in ("x", "y", "weight")})

    return place
