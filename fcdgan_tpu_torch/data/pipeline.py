"""Host batches: fixed shapes, wrap padding, a background prefetch queue,
the native C++ loaders and their device half.

Port of the JAX package's ``data/pipeline.py`` (:24-511). ``BatchLoader``
yields fixed-shape weighted batches of a dataset's tuple fields: the tail is
wrap-padded from the epoch's own order with weight 0 (``tail='pad'``) or
yielded short (``tail='short'``, the reference's ``drop_last=False``). The
numpy shuffle is seeded, so a seed gives the JAX package's batch order.
``PairBatchLoader`` does the same over the changed/unchanged pairs of a
``WHUPairDataset``. ``prefetch`` runs an iterator on a background thread
into a bounded queue, so tile reads and assembly overlap the device.

The native loaders assemble the same batches in the C++ thread pool of
``native/tileio.cpp``: ``NativeSceneBatchLoader`` (a scene pair; with
``device_normalize`` it ships raw tiles in the rasters' stored type plus
each tile's write window, and ``DeviceNormalizer`` normalizes and pad-masks
them on the device), ``NativeOSCDBatchLoader`` (an RSSS scene list) and
``NativeWHUBatchLoader`` / ``NativeWHUPairBatchLoader`` (WHU slices). As in
the JAX package they wrap-pad the tail with weight-0 duplicates. Callers
pick one after its explicit check (``supports`` of the loader, or
``native.can_open`` on the rasters), never by catching a loader's error.
``device_put_batch`` uploads a host batch through pinned memory with
``non_blocking`` copies.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


class Batch(dict):
    """A dict batch with attribute access (x, y, ref, item, weight, ...)."""

    __getattr__ = dict.__getitem__


def _collate(samples: Sequence[tuple], fields: Sequence[str]) -> Batch:
    out = Batch()
    for i, name in enumerate(fields):
        vals = [s[i] for s in samples]
        if np.isscalar(vals[0]) or np.asarray(vals[0]).ndim == 0:
            out[name] = np.asarray(vals)
        else:
            out[name] = np.stack(vals)
    return out


class BatchLoader:
    """Epoch iterator over a dataset producing fixed-shape weighted batches.

    ``fields`` names the dataset's tuple positions (scene: ('x', 'y',
    'item', 'ref')). ``epoch_hook(epoch)`` runs at the start of each epoch,
    before the shuffle."""

    def __init__(self, dataset, batch_size: int, fields: Sequence[str],
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 epoch_hook: Optional[Callable[[int], None]] = None, tail: str = "pad"):
        if tail not in ("pad", "short"):
            raise ValueError("tail must be 'pad' or 'short'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.fields = tuple(fields)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.tail = tail
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        self._epoch_hook = epoch_hook

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        """(idx, weight) per batch: the epoch's order, the tail wrap-padded
        with weight-0 entries or short."""
        if self._epoch_hook is not None:
            self._epoch_hook(self._epoch)
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            weight = np.ones(len(idx), np.float32)
            if len(idx) < bs and self.tail == "pad":
                extra = np.resize(order, bs - len(idx))  # wraps a dataset smaller than bs
                idx = np.concatenate([idx, extra])
                weight = np.concatenate([weight, np.zeros(bs - len(weight), np.float32)])
            yield idx, weight

    def __iter__(self) -> Iterator[Batch]:
        for idx, weight in self._index_batches():
            batch = _collate([self.dataset[int(i)] for i in idx], self.fields)
            batch["weight"] = weight
            yield batch


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` on a background thread with a bounded ready queue;
    an error there is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # re-raised in the consumer below
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


class PairBatchLoader(BatchLoader):
    """BatchLoader over a ``WHUPairDataset``: (changed, unchanged) fields as
    ``c_*`` and ``nc_*`` of one batch with a shared weight vector (JAX
    pipeline.py:117-139)."""

    def __init__(self, dataset, batch_size, c_fields, nc_fields, **kw):
        class _Adapter:
            def __len__(self):
                return len(dataset)

            def __getitem__(self, i):
                c, nc = dataset[i]
                return tuple(c) + tuple(nc)

        super().__init__(_Adapter(), batch_size,
                         fields=tuple(f"c_{f}" for f in c_fields)
                         + tuple(f"nc_{f}" for f in nc_fields), **kw)


def _normalize_stats(enhance) -> dict:
    """The mean/std keywords of ``NativePairAssembler`` for a ``Normalize``
    enhance (none for None)."""
    from .normalize import Normalize

    if enhance is None:
        return {}
    if not isinstance(enhance, Normalize):
        raise ValueError("native loader supports Normalize enhance only")
    return dict(mean_x=enhance.meansX, std_x=enhance.stdX,
                mean_y=enhance.meansY, std_y=enhance.stdY)


def _paste(dst: np.ndarray, raster, read, write, dtype) -> None:
    """A raster's read window into a canvas at its write offset."""
    dst[write[1]:write[1] + write[3], write[0]:write[0] + write[2], :] = \
        raster.read_block(*read).astype(dtype)


class NativeSceneBatchLoader(BatchLoader):
    """BatchLoader over a ``ScenePairDataset`` whose x/y tiles are assembled
    by the native library (JAX pipeline.py:167-273); the 1-band reference
    tile stays on the Python path. The same (x, y, item, ref, weight)
    batches as ``BatchLoader``, the tail wrap-padded.

    ``device_normalize=True`` ships raw tiles in the rasters' stored type
    (shared and integral), the raw reference (its own type when an integer
    of at most 2 bytes, else float32) and ``win``, each tile's (x0, y0, w,
    h) write window, for ``DeviceNormalizer``: 2-4x fewer upload bytes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 n_threads: Optional[int] = None, device_normalize: bool = False):
        from .. import native

        stats = _normalize_stats(dataset.enhance)
        self._asm = native.NativePairAssembler(
            dataset.raster_x.path, dataset.raster_y.path, dataset.patch_size,
            dataset.overlap_padding, n_threads=n_threads,
            **({} if device_normalize else stats))
        self.device_normalize = bool(device_normalize)
        if self.device_normalize:
            code = self._asm.rx.dtype_code
            if code != self._asm.ry.dtype_code or code not in native.INTEGRAL_CODES:
                raise ValueError("device_normalize requires a shared integral raster dtype")
            self._wins = dataset.grid.write_windows()
            rr = dataset.raster_ref
            self._ref_dtype = (rr.dtype if rr is not None and np.issubdtype(rr.dtype, np.integer)
                               and rr.dtype.itemsize <= 2 else np.dtype(np.float32))
        super().__init__(dataset, batch_size, fields=("x", "y", "item", "ref"),
                         shuffle=shuffle, seed=seed)

    @staticmethod
    def supports_device_normalize(dataset) -> bool:
        """Whether the dataset can ship raw tiles: the native library reads
        both rasters, a ``Normalize`` enhance or none, and one shared
        integral stored type (JAX pipeline.py:220-243)."""
        from .. import native
        from .normalize import Normalize

        if dataset.enhance is not None and not isinstance(dataset.enhance, Normalize):
            return False
        paths = (dataset.raster_x.path, dataset.raster_y.path)
        if not all(native.can_open(p) for p in paths):
            return False
        codes = {native.NativeRaster(p).dtype_code for p in paths}
        return len(codes) == 1 and codes.pop() in native.INTEGRAL_CODES

    def __iter__(self) -> Iterator[Batch]:
        raw = self.device_normalize
        ds = self.dataset
        ph, pw = ds.patch_size[1], ds.patch_size[0]
        ref_dt = self._ref_dtype if raw else np.float32
        for idx, weight in self._index_batches():
            x, y = (self._asm.assemble_raw if raw else self._asm.assemble)(idx.tolist())
            refs = np.zeros((len(idx), ph, pw, 1), ref_dt)
            if ds.raster_ref is not None:
                for pos, i in enumerate(idx):
                    _, read, write = ds.grid.slices(int(i))
                    _paste(refs[pos], ds.raster_ref, read, write, ref_dt)
            batch = Batch(x=x, y=y, item=np.asarray(idx, np.int64), ref=refs, weight=weight)
            if raw:
                batch["win"] = self._wins[np.asarray(idx, np.int64)]
            yield batch


class NativeOSCDBatchLoader(BatchLoader):
    """BatchLoader over an ``OSCDDataset`` with one native assembler per
    scene (JAX pipeline.py:275-352): a batch's items are grouped by scene,
    one assembler call each; the 1-band ref and region tiles stay on the
    Python path. The same (x, y, item, ref, region, weight) batches as
    ``BatchLoader(tail='pad')``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 n_threads: Optional[int] = None):
        from .. import native

        self._assemblers = [
            native.NativePairAssembler(s.ds.raster_x.path, s.ds.raster_y.path,
                                       s.ds.patch_size, s.ds.overlap_padding,
                                       n_threads=n_threads, **_normalize_stats(s.ds.enhance))
            for s in dataset.dslist]
        super().__init__(dataset, batch_size, fields=("x", "y", "item", "ref", "region"),
                         shuffle=shuffle, seed=seed)

    @staticmethod
    def supports(dataset) -> bool:
        """Whether the native library reads every scene's image pair."""
        from .. import native

        return bool(len(dataset)) and all(
            native.can_open(p) for s in dataset.dslist
            for p in (s.ds.raster_x.path, s.ds.raster_y.path))

    def __iter__(self) -> Iterator[Batch]:
        ds = self.dataset
        ph, pw = ds.patch_size[1], ds.patch_size[0]
        nb = self._assemblers[0].nband
        for idx, weight in self._index_batches():
            n = len(idx)
            x = np.zeros((n, ph, pw, nb), np.float32)
            y = np.zeros((n, ph, pw, nb), np.float32)
            located = [ds._locate(int(i)) for i in idx]
            by_scene: Dict[int, list] = {}
            for pos, (s, cur) in enumerate(located):
                by_scene.setdefault(s, []).append((pos, cur))
            for s, entries in by_scene.items():
                sx, sy = self._assemblers[s].assemble([cur for _, cur in entries])
                pos = [p for p, _ in entries]
                x[pos], y[pos] = sx, sy
            refs = np.zeros((n, ph, pw, 1), np.float32)
            regions = np.zeros((n, ph, pw, 1), np.float32)
            for pos, (s, cur) in enumerate(located):
                scene = ds.dslist[s]
                _, read, write = scene.ds.grid.slices(cur)
                if scene.ds.raster_ref is not None:
                    _paste(refs[pos], scene.ds.raster_ref, read, write, np.float32)
                if scene.raster_region is not None:
                    _paste(regions[pos], scene.raster_region, read, write, np.float32)
            regions[regions > 125] = 1
            yield Batch(x=x, y=y, item=np.asarray(idx, np.int64), ref=refs,
                        region=regions, weight=weight)


class _WHUNativeReader:
    """Native threaded whole-slice reads for a ``WHUDataset`` (JAX
    pipeline.py:354-405): x/y batches normalized in the library, the
    changed slices' references binarized ``> 0``, label.txt's codes."""

    def __init__(self, ds, n_threads: Optional[int] = None):
        from .. import native
        from .normalize import Normalize

        self.mean_x = self.std_x = self.mean_y = self.std_y = None
        if ds.scale is not None:
            if not isinstance(ds.scale, Normalize):
                raise ValueError("native loader supports Normalize scale only")
            self.mean_x, self.std_x = ds.scale.meansX, ds.scale.stdX
            self.mean_y, self.std_y = ds.scale.meansY, ds.scale.stdY
        self._native = native
        self.ds = ds
        probe = native.NativeRaster(ds.img_path_x[0])
        self.h, self.w, self.nband = probe.ysize, probe.xsize, probe.nband
        probe.close()
        self.labels = np.asarray([[int(v) for v in li[1:4]] for li in ds.label_list], np.int32)
        self.n_threads = n_threads

    def batch(self, idx) -> Dict:
        ds, read = self.ds, self._native.read_files_f32
        x = read([ds.img_path_x[int(i)] for i in idx], self.h, self.w, self.nband,
                 mean=self.mean_x, std=self.std_x, n_threads=self.n_threads)
        y = read([ds.img_path_y[int(i)] for i in idx], self.h, self.w, self.nband,
                 mean=self.mean_y, std=self.std_y, n_threads=self.n_threads)
        ref = np.zeros((len(idx), self.h, self.w, 1), np.float32)
        changed = [(pos, int(i)) for pos, i in enumerate(idx) if self.labels[int(i), 2] == 1]
        if changed:
            r = read([ds.ref_path[i] for _, i in changed], self.h, self.w, 1,
                     n_threads=self.n_threads)
            ref[[pos for pos, _ in changed]] = (r > 0).astype(np.float32)
        return dict(x=x, y=y, ref=ref, label=self.labels[np.asarray(idx, np.int64)])


class NativeWHUBatchLoader(BatchLoader):
    """BatchLoader over a ``WHUDataset`` with native slice reads (JAX
    pipeline.py:407-421): the (x, y, ref, item, label, weight) batches of
    ``BatchLoader``, the tail wrap-padded."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 n_threads: Optional[int] = None, **kw):
        self._reader = _WHUNativeReader(dataset, n_threads)
        super().__init__(dataset, batch_size, fields=("x", "y", "ref", "item", "label"),
                         shuffle=shuffle, seed=seed, **kw)

    @staticmethod
    def supports(ds) -> bool:
        """Whether the native library reads a WHU slice set (its first slice;
        a PNG set goes through the Python loaders)."""
        from .. import native

        return bool(len(ds)) and native.can_open(ds.img_path_x[0])

    def __iter__(self) -> Iterator[Batch]:
        for idx, weight in self._index_batches():
            yield Batch(item=np.asarray(idx, np.int64), weight=weight, **self._reader.batch(idx))


class NativeWHUPairBatchLoader(BatchLoader):
    """``PairBatchLoader`` over a ``WHUPairDataset`` with native slice reads
    (JAX pipeline.py:423-451): each epoch's pairing resolved through
    ``c_order`` / ``nc_order`` (``epoch_hook`` re-pairs before the shuffle),
    the tail wrap-padded."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 n_threads: Optional[int] = None, **kw):
        self._pair = dataset
        self._c = _WHUNativeReader(dataset.c_ds, n_threads)
        self._nc = _WHUNativeReader(dataset.nc_ds, n_threads)
        fields = ("x", "y", "ref", "item", "label")
        super().__init__(dataset, batch_size, fields=tuple(f"c_{f}" for f in fields)
                         + tuple(f"nc_{f}" for f in fields), shuffle=shuffle, seed=seed, **kw)

    def __iter__(self) -> Iterator[Batch]:
        for idx, weight in self._index_batches():
            idx_c = np.asarray([self._pair.c_order[int(i)] for i in idx], np.int64)
            idx_nc = np.asarray([self._pair.nc_order[int(i)] for i in idx], np.int64)
            out = Batch(weight=weight)
            out.update({f"c_{k}": v for k, v in self._c.batch(idx_c).items()}, c_item=idx_c)
            out.update({f"nc_{k}": v for k, v in self._nc.batch(idx_nc).items()},
                       nc_item=idx_nc)
            yield out


def _norm_stats(normalize, nband: int, device):
    """The (mean_x, std_x, mean_y, std_y) f32 rows of a ``Normalize`` on
    ``device``, the identity for None (a dataset without an enhance)."""
    if normalize is None:
        stats = (np.zeros(nband), np.ones(nband), np.zeros(nband), np.ones(nband))
    else:
        stats = (normalize.meansX, normalize.stdX, normalize.meansY, normalize.stdY)
    return [torch.tensor(np.asarray(v[:nband], np.float32), device=device) for v in stats]


def _normalize_masked(x: torch.Tensor, y: torch.Tensor, win: torch.Tensor, norm):
    """Raw NHWC tiles x, y -> per band ``(v - mean) / std`` in float32 (the
    host ``Normalize``'s subtract and divide), zero outside each tile's
    write window ``win`` (B, 4: x0, y0, w, h). ``norm`` holds the
    (mean_x, std_x, mean_y, std_y) rows, broadcast against the tiles: one
    row per band, or one per tile (B, 1, 1, C). The one body of every
    device feed's normalization."""
    dev = x.device
    win = win.long().view(-1, 4, 1, 1, 1)
    rows = torch.arange(x.shape[1], device=dev).view(1, -1, 1, 1)
    cols = torch.arange(x.shape[2], device=dev).view(1, 1, -1, 1)
    x0, y0, ww, wh = win[:, 0], win[:, 1], win[:, 2], win[:, 3]
    mask = (rows >= y0) & (rows < y0 + wh) & (cols >= x0) & (cols < x0 + ww)
    mx, sx, my, sy = norm
    zero = torch.zeros((), device=dev)
    return (torch.where(mask, (x.float() - mx) / sx, zero),
            torch.where(mask, (y.float() - my) / sy, zero))


class DeviceNormalizer:
    """The device half of a raw batch (JAX pipeline.py:453-501):
    ``_normalize_masked`` on the batch's device, the reference cast to
    float32."""

    def __init__(self, normalize, nband: int, device):
        self._norm = _norm_stats(normalize, nband, device)

    def __call__(self, batch: Dict) -> Dict:
        """A raw device batch (x, y, ref, win, ...) -> the normalized float32
        batch without ``win``; a batch without ``win`` is returned as is."""
        if "win" not in batch:
            return batch
        out = Batch({k: v for k, v in batch.items() if k != "win"})
        out["x"], out["y"] = _normalize_masked(batch["x"], batch["y"], batch["win"], self._norm)
        out["ref"] = batch["ref"].float()
        return out


def upload(a: np.ndarray, device: torch.device,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array on ``device`` (in ``dtype`` when given, cast on the
    host): to a card through pinned memory with a ``non_blocking`` copy, so
    the host does not wait for the work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_put_batch(batch: Dict, device) -> Batch:
    """Every array of a host batch on ``device`` (JAX pipeline.py:503-511),
    each through ``upload``."""
    device = torch.device(device)
    return Batch({k: upload(np.asarray(v), device) for k, v in batch.items()})
