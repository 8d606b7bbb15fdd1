"""Device-resident data: the scene pair of USSS and serving, the WHU slices of WSSS.

Counterpart of ``DeviceSceneCache`` and ``IndexBatchLoader`` in the JAX
package's ``data/device_cache.py`` (:33-45, :239-441, with the ``prep`` and
``run`` bodies of ``_scene_jits``, :77-236). The zero-padded raw scene pair
(and the reference raster, when there is one) is uploaded once. A tile is
gathered on the device from its fixed canvas origin
(``TileGrid.canvas_origins``), normalized per band, and zeroed outside the
tile's write window. Training batches are (item, weight) index pairs from
``IndexBatchLoader`` (``loader``), turned into device tiles by ``complete``.
For serving, per chunk of tiles the Segmentor runs, each tile's
stride-sized interior is cropped and written into a device canvas, and the
finished raster is quantized to the download type and downloaded once
(``stitched_density``, or ``stitched_density_start`` / ``_finish`` for a
caller that overlaps scenes).

Chunks come from ``serve_chunks``: batch-exact unless ``FCDGAN_SERVE_BS``
widens them, the last one wrap-padded with the first tiles again. A raster
is held in its stored type when that is an integer of at most 2 bytes
(uint8, uint16, int16, ...) and in float32 otherwise, and cast to float32
at gather time (``prep``, device_cache.py:263-272). ``fits()`` budgets
those bytes against ``FCDGAN_SCENE_CACHE_MAX_MB`` (default 4096,
:331-342); ``supports()`` adds the enhance rule, and callers stream a scene
it refuses (the rolling-window cache of the JAX package is not ported yet).

``DeviceWHUCache`` is the counterpart of the JAX ``DeviceWHUCache``
(:1154-1307): the raw changed and unchanged slice stacks and the binarized
changed references stay on the device in their stored type, and
``complete_pair`` / ``complete_unc`` / ``complete_c`` gather and normalize
the batches of ``IndexPairBatchLoader`` / ``IndexBatchLoader`` there.

``DeviceOSCDCache`` is the counterpart of the JAX ``DeviceOSCDCache``
(:1310-1455) for the RSSS scene lists: raw fixed-shape tile canvases in the
scenes' common stored type (the same rule), each item's per-scene mean/std
rows and write window, normalized and pad-masked on the device by
``complete``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.download import Download, dequantize, quantize
from .normalize import Normalize
from .pipeline import Batch, BatchLoader

# bytes the resident raw WHU slice stacks may take on the device, in their
# stored type (the JAX default of FCDGAN_SLICE_CACHE_MAX_MB, :1253)
SLICE_CACHE_MAX_BYTES = 4096 * 10**6


class IndexBatchLoader(BatchLoader):
    """Epoch iterator of (item, weight) batches (JAX ``IndexBatchLoader``,
    device_cache.py:33-45, over the order logic of ``pipeline.BatchLoader``):
    a seeded numpy shuffle of ``n_items`` ids per epoch, so the same seed
    gives the JAX package's batch order, and the last partial batch at its
    true size (the reference's ``drop_last=False``, ``tail='short'``) or
    wrap-padded with weight 0 (``tail='pad'``). ``epoch_hook(epoch)`` runs
    at the start of each epoch, before the shuffle."""

    def __init__(self, n_items: int, batch_size: int, shuffle: bool = False,
                 seed: int = 0, epoch_hook: Optional[Callable[[int], None]] = None,
                 tail: str = "short"):
        super().__init__(range(n_items), batch_size, fields=("item",), shuffle=shuffle,
                         seed=seed, epoch_hook=epoch_hook, tail=tail)

    def __iter__(self):
        for idx, weight in self._index_batches():
            yield Batch(item=idx.astype(np.int64), weight=weight)


class IndexPairBatchLoader(IndexBatchLoader):
    """Index-only loader over a ``WHUPairDataset`` (JAX device_cache.py:
    1131-1151): each epoch's ``order_reset`` pairing (run by the epoch hook,
    before the shuffle) resolved to (c_item, nc_item) table lookups."""

    def __init__(self, pair_ds, batch_size: int, shuffle: bool = False, seed: int = 0,
                 epoch_hook: Optional[Callable[[int], None]] = None):
        super().__init__(len(pair_ds), batch_size, shuffle=shuffle, seed=seed,
                         epoch_hook=epoch_hook)
        self.pair_ds = pair_ds

    def __iter__(self):
        pair = self.pair_ds
        for b in super().__iter__():
            idx = b["item"]
            yield {"c_item": np.asarray([pair.c_order[int(i)] for i in idx], np.int64),
                   "nc_item": np.asarray([pair.nc_order[int(i)] for i in idx], np.int64),
                   "weight": b["weight"]}


def held_dtype(dtype) -> np.dtype:
    """The type a raster is held in on the device: its own when it is an
    integer of at most 2 bytes, else float32 (device_cache.py:263-272)."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer) and dtype.itemsize <= 2:
        return dtype
    return np.dtype(np.float32)


def _budget_mb(var: str) -> float:
    """The device budget in MB that ``var`` sets (the JAX default 4096)."""
    return float(os.environ.get(var, "4096"))


# CUDA's index kernels take no unsigned type wider than a byte, so a uint16
# stack is gathered through its int16 view (the same bits) and cast after
_INDEX_VIEW = {torch.uint16: torch.int16}


def _take(t: torch.Tensor, *index) -> torch.Tensor:
    """``t[index]`` for any held type."""
    view = _INDEX_VIEW.get(t.dtype)
    return t[index] if view is None else t.view(view)[index].view(t.dtype)


def serve_chunks(n: int, bs: int) -> np.ndarray:
    """(n_chunks, bs_eff) tile ids of the fused serving pass, wrap-padded
    (JAX ``DeviceSceneWindowCache._serve_chunks``, device_cache.py:991-1009):
    ``ceil(n / bs_eff)`` chunks, the last one filled up with the first tiles
    again (their interiors are re-written with identical values).
    ``FCDGAN_SERVE_BS`` above 0 widens the chunk to ``min(max(bs, cap), n)``
    tiles; unset or 0 keeps it batch-exact, ``min(bs, n)``."""
    cap = int(os.environ.get("FCDGAN_SERVE_BS", "0"))
    bs_eff = min(max(bs, cap), n) if cap > 0 else min(bs, n)
    nc = -(-n // bs_eff)
    return np.resize(np.arange(n, dtype=np.int64), nc * bs_eff).reshape(nc, bs_eff)


class DeviceSceneCache:
    """Raw scene pair resident on ``device`` + gathered, normalized tiles."""

    def __init__(self, dataset, normalize, device):
        if not self.fits(dataset):
            raise NotImplementedError(
                f"the scene takes {self.scene_bytes(dataset) / 1e6:.0f} MB on the device, "
                "past FCDGAN_SCENE_CACHE_MAX_MB "
                f"({_budget_mb('FCDGAN_SCENE_CACHE_MAX_MB'):g} MB): serve it through the "
                "streaming path (tools.infer --device-feed stream, which --device-feed auto "
                "takes for it); the rolling-window cache (DeviceSceneWindowCache) is not "
                "ported yet (ROADMAP.md, A.3)")
        if normalize is not None and not isinstance(normalize, Normalize):
            raise ValueError("DeviceSceneCache needs a Normalize enhance (or none)")
        grid = dataset.grid
        self.grid = grid
        self.device = torch.device(device)
        hp, wp = grid.padded_shape()
        padx, pady = grid.overlap_padding
        nband = dataset.raster_x.nband

        def padded(raster):
            out = np.zeros((hp, wp, raster.nband), held_dtype(raster.dtype))
            out[pady:pady + raster.ysize, padx:padx + raster.xsize] = \
                raster.read_block(0, 0, raster.xsize, raster.ysize)
            return torch.from_numpy(out).to(self.device)

        self.px = padded(dataset.raster_x)
        self.py = padded(dataset.raster_y)
        rr = dataset.raster_ref
        self.pref = padded(rr) if rr is not None else None
        self.origins = grid.canvas_origins()
        self._org = torch.from_numpy(self.origins.astype(np.int64)).to(self.device)
        self._wins = torch.from_numpy(grid.write_windows().astype(np.int64)).to(self.device)
        self.scene_hw = (dataset.raster_x.ysize, dataset.raster_x.xsize)
        self.n_tiles = len(dataset)
        if normalize is None:  # identity, as the JAX cache without an enhance
            stats = (np.zeros(nband), np.ones(nband), np.zeros(nband), np.ones(nband))
        else:
            stats = (normalize.meansX, normalize.stdX, normalize.meansY, normalize.stdY)
        self._norm = [torch.tensor(np.asarray(s[:nband], np.float32), device=self.device)
                      for s in stats]

    @staticmethod
    def supports(dataset) -> bool:
        """Whether ``dataset`` can be served from a resident scene
        (device_cache.py:318-329): a ``Normalize`` enhance or none (the
        port's scene datasets take no sync transforms) and ``fits``.
        Callers test it and stream the scene otherwise."""
        enhance = dataset.enhance
        return (enhance is None or isinstance(enhance, Normalize)) and \
            DeviceSceneCache.fits(dataset)

    @staticmethod
    def scene_bytes(dataset) -> int:
        """Device bytes of the padded rasters in their held types."""
        hp, wp = dataset.grid.padded_shape()
        rasters = (dataset.raster_x, dataset.raster_y, dataset.raster_ref)
        return sum(hp * wp * r.nband * held_dtype(r.dtype).itemsize
                   for r in rasters if r is not None)

    @staticmethod
    def fits(dataset) -> bool:
        """Whether the rasters fit ``FCDGAN_SCENE_CACHE_MAX_MB``
        (device_cache.py:331-342)."""
        return DeviceSceneCache.scene_bytes(dataset) <= \
            _budget_mb("FCDGAN_SCENE_CACHE_MAX_MB") * 1e6

    def _gather(self, ids: torch.Tensor, with_ref: bool = False):
        """NHWC f32 tiles of ``ids``: normalized x and y, zero outside each
        write window, and the raw reference tile, each cast to f32 after the
        gather (the ``prep`` body, device_cache.py:87-123)."""
        ph, pw = self.grid.canvas_shape()
        org = self._org[ids]
        win = self._wins[ids]                                     # (x0, y0, w, h)
        ar_h = torch.arange(ph, device=self.device)
        ar_w = torch.arange(pw, device=self.device)
        rows = (org[:, 0, None] + ar_h)[:, :, None]               # (B, ph, 1)
        cols = (org[:, 1, None] + ar_w)[:, None, :]               # (B, 1, pw)
        r = ar_h[None, :, None]
        c = ar_w[None, None, :]
        x0, y0 = win[:, 0, None, None], win[:, 1, None, None]
        ww, wh = win[:, 2, None, None], win[:, 3, None, None]
        mask = ((r >= y0) & (r < y0 + wh) & (c >= x0) & (c < x0 + ww))[..., None]
        mx, sx, my, sy = self._norm
        zero = torch.zeros((), device=self.device)
        x = torch.where(mask, (_take(self.px, rows, cols).float() - mx) / sx, zero)
        y = torch.where(mask, (_take(self.py, rows, cols).float() - my) / sy, zero)
        if not with_ref:
            return x, y, None
        if self.pref is None:
            ref = torch.zeros((len(ids), ph, pw, 1), device=self.device)
        else:
            ref = _take(self.pref, rows, cols).float()
        return x, y, ref

    def tiles(self, ids: torch.Tensor):
        """Normalized (B, C, ph, pw) channels_last f32 tiles x, y of ``ids``."""
        x, y, _ = self._gather(ids)
        return x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)

    def complete(self, batch) -> dict:
        """An ``IndexBatchLoader`` batch -> the device batch of the train
        steps: NHWC f32 ``x``, ``y``, ``ref`` (B, ph, pw, 1), int64 ``item``
        and f32 ``weight`` (device_cache.py:344-354)."""
        item = torch.from_numpy(np.asarray(batch["item"], np.int64)).to(self.device)
        weight = torch.from_numpy(np.asarray(batch["weight"], np.float32)).to(self.device)
        x, y, ref = self._gather(item, with_ref=True)
        return {"x": x, "y": y, "ref": ref, "item": item, "weight": weight}

    def loader(self, batch_size: int, shuffle: bool = False,
               seed: int = 0) -> IndexBatchLoader:
        """Epoch batches over this scene's tiles, for ``complete``."""
        return IndexBatchLoader(self.n_tiles, batch_size, shuffle=shuffle, seed=seed)

    @torch.no_grad()
    def stitched_density_start(self, model, batch_size: int = 10,
                               density_dtype: str = "float32") -> Download:
        """Queue the whole-scene density and its download; return at once.

        Per ``serve_chunks`` chunk the Segmentor runs on the gathered tiles
        and each tile's stride-sized interior is written into one device
        canvas (disjoint writes; the ``run`` body, device_cache.py:125-154);
        the (ysize, xsize) canvas is quantized to ``density_dtype`` and
        copied ``non_blocking`` into pinned host memory behind a recorded
        event. A caller with several scenes starts the next one before it
        finishes this one (tools/infer.py ``run_oscd``)."""
        ph, pw = self.grid.canvas_shape()
        padx, pady = self.grid.overlap_padding
        sy, sx = ph - 2 * pady, pw - 2 * padx
        hp, wp = self.grid.padded_shape()
        canvas = torch.zeros((hp - 2 * pady, wp - 2 * padx), device=self.device)
        chunks = serve_chunks(self.n_tiles, batch_size)
        ids_dev = torch.from_numpy(chunks).to(self.device)
        for i, ids in enumerate(chunks):
            x, y = self.tiles(ids_dev[i])
            core = model(x, y)[:, 0, pady:pady + sy, padx:padx + sx]
            for j, item in enumerate(ids):
                r0, c0 = self.origins[item]
                canvas[r0:r0 + sy, c0:c0 + sx] = core[j]
        hs, ws = self.scene_hw
        return Download(quantize(canvas[:hs, :ws], density_dtype))

    @staticmethod
    def stitched_density_finish(handle: Download, density_dtype: str = "float32") -> np.ndarray:
        """Wait for a ``stitched_density_start`` download: the float32
        (ysize, xsize) host density (uint8 dequantized by / 255)."""
        return dequantize(handle.result(), density_dtype)

    def stitched_density(self, model, batch_size: int = 10,
                         density_dtype: str = "float32") -> np.ndarray:
        """Whole-scene float32 density: start, then finish."""
        return self.stitched_density_finish(
            self.stitched_density_start(model, batch_size, density_dtype), density_dtype)


class DeviceWHUCache:
    """Raw WHU slice stacks resident on ``device`` + gathered, normalized
    batches: changed/unchanged pairs for the adversarial phase, unchanged
    slices for the G pretrain, changed slices for the final inference."""

    def __init__(self, pair_ds, normalize, device):
        c_ds, nc_ds = pair_ds.c_ds, pair_ds.nc_ds
        if not (c_ds and nc_ds):
            raise ValueError("DeviceWHUCache needs changed and unchanged slices")
        if not isinstance(normalize, Normalize):
            raise ValueError("DeviceWHUCache needs a Normalize scale")
        from .raster import read_image

        probe = read_image(c_ds.img_path_x[0])
        n = len(c_ds) + len(nc_ds)
        need = (2 * n + len(c_ds)) * probe.nbytes
        if need > SLICE_CACHE_MAX_BYTES:
            raise NotImplementedError(
                f"the WHU slices take {need / 1e6:.0f} MB on the device, past the "
                f"resident cache budget ({SLICE_CACHE_MAX_BYTES / 1e6:.0f} MB); the host "
                "slice loaders are not ported yet (ROADMAP.md, queue A)")
        self.device = torch.device(device)

        def stack(paths):
            return torch.from_numpy(np.stack([read_image(p) for p in paths])).to(self.device)

        self._cx, self._cy = stack(c_ds.img_path_x), stack(c_ds.img_path_y)
        self._nx, self._ny = stack(nc_ds.img_path_x), stack(nc_ds.img_path_y)
        # the changed slices' references, binarized > 0 (data_utils.py:501-508);
        # the unchanged slices' references are zero by construction
        self.cref_host = np.stack([c_ds.raw_ref(i, probe.shape[:2]) for i in range(len(c_ds))])
        self._cref = torch.from_numpy(self.cref_host).to(self.device)
        self.nband = probe.shape[-1]
        self.hw = probe.shape[:2]
        stats = (normalize.meansX, normalize.stdX, normalize.meansY, normalize.stdY)
        self._norm = [torch.tensor(v[:self.nband], dtype=torch.float32, device=self.device)
                      for v in stats]

    def _ids(self, items) -> torch.Tensor:
        return torch.from_numpy(np.asarray(items, np.int64)).to(self.device)

    def _xy(self, sx: torch.Tensor, sy: torch.Tensor, ids: torch.Tensor):
        mx, stx, my, sty = self._norm
        return (sx[ids].float() - mx) / stx, (sy[ids].float() - my) / sty

    def _weight(self, batch) -> torch.Tensor:
        return torch.from_numpy(np.asarray(batch["weight"], np.float32)).to(self.device)

    def complete_pair(self, batch) -> dict:
        """An ``IndexPairBatchLoader`` batch -> NHWC f32 ``c_x``, ``c_y``,
        ``c_ref`` (B, h, w, 1), ``nc_x``, ``nc_y`` and f32 ``weight``
        (device_cache.py:1216-1223, 1266-1275)."""
        ci, ni = self._ids(batch["c_item"]), self._ids(batch["nc_item"])
        c_x, c_y = self._xy(self._cx, self._cy, ci)
        nc_x, nc_y = self._xy(self._nx, self._ny, ni)
        return {"c_x": c_x, "c_y": c_y, "c_ref": self._cref[ci].float(), "nc_x": nc_x,
                "nc_y": nc_y, "weight": self._weight(batch)}

    def complete_unc(self, batch) -> dict:
        """An ``IndexBatchLoader`` batch over the unchanged slices -> NHWC f32
        ``x``, ``y``, int64 ``item`` and f32 ``weight``."""
        item = self._ids(batch["item"])
        x, y = self._xy(self._nx, self._ny, item)
        return {"x": x, "y": y, "item": item, "weight": self._weight(batch)}

    def complete_c(self, batch) -> dict:
        """The same over the changed slices (the final inference)."""
        item = self._ids(batch["item"])
        x, y = self._xy(self._cx, self._cy, item)
        return {"x": x, "y": y, "item": item, "weight": self._weight(batch)}


def oscd_held_dtype(dataset) -> np.dtype:
    """The held type of an OSCD scene list's x/y tile stacks: the scenes'
    common stored type by ``held_dtype`` (device_cache.py:1334-1339)."""
    scenes = [s.ds for s in dataset.dslist]
    return held_dtype(np.result_type(*[r.dtype for s in scenes
                                       for r in (s.raster_x, s.raster_y)]))


class DeviceOSCDCache:
    """Raw tile stacks of an ``OSCDDataset`` resident on ``device``.

    The scenes have per-scene normalizers, so every tile's raw canvas (the
    clamped read window zero-padded to the patch) is assembled once on the
    host, with its scene's mean/std rows and its write window; ``complete``
    gathers a batch, normalizes it and zeroes it outside each write window on
    the device. The region raster passes through as the host dataset gives
    it: values above 125 become 1, smaller ones stay (data_utils.py:273-282).
    One batch upload is the (item, weight) pair."""

    def __init__(self, dataset, device):
        n = len(dataset)
        if n == 0:
            raise ValueError("DeviceOSCDCache needs a non-empty dataset")
        if any(s.ds.enhance is not None and not isinstance(s.ds.enhance, Normalize)
               for s in dataset.dslist):
            raise ValueError("DeviceOSCDCache needs Normalize scalers")
        if not self.supports(dataset):
            raise NotImplementedError(
                f"the OSCD tiles take {self.tile_bytes(dataset) / 1e6:.0f} MB on the device, "
                "past FCDGAN_TILE_CACHE_MAX_MB "
                f"({_budget_mb('FCDGAN_TILE_CACHE_MAX_MB'):g} MB); the host tile loaders "
                "are not ported yet (ROADMAP.md, queue A)")
        self.device = torch.device(device)
        grid0 = dataset.dslist[0].ds.grid
        ph, pw = grid0.canvas_shape()
        nband = dataset.dslist[0].ds.raster_x.nband
        held = oscd_held_dtype(dataset)
        xs = np.zeros((n, ph, pw, nband), held)
        ys = np.zeros((n, ph, pw, nband), held)
        refs = np.zeros((n, ph, pw, 1), np.float32)
        regions = np.zeros((n, ph, pw, 1), np.float32)
        norm = np.zeros((4, n, nband), np.float32)
        norm[1] = norm[3] = 1.0
        wins = np.zeros((n, 4), np.int64)
        for item in range(n):
            s_idx, cur = dataset._locate(item)
            scene = dataset.dslist[s_idx]
            base = scene.ds
            _, read, write = base.grid.slices(cur)
            win = (slice(write[1], write[1] + write[3]), slice(write[0], write[0] + write[2]))
            xs[(item, *win)] = base.raster_x.read_block(*read)
            ys[(item, *win)] = base.raster_y.read_block(*read)
            if base.raster_ref is not None:
                refs[(item, *win)] = base.raster_ref.read_block(*read)
            if scene.raster_region is not None:
                g = scene.raster_region.read_block(*read).astype(np.float32)
                regions[(item, *win)] = np.where(g > 125, np.float32(1), g)
            if base.enhance is not None:
                e = base.enhance
                for row, stats in enumerate((e.meansX, e.stdX, e.meansY, e.stdY)):
                    norm[row, item] = np.asarray(stats[:nband], np.float32)
            wins[item] = write
        dev = self.device
        self.nband = nband
        self.n_tiles = n
        self._xs, self._ys = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        self._refs = torch.from_numpy(refs).to(dev)
        self._regions = torch.from_numpy(regions).to(dev)
        self._norm = torch.from_numpy(norm).to(dev)
        self._wins = torch.from_numpy(wins).to(dev)
        self._rows = torch.arange(ph, device=dev).view(1, ph, 1, 1)
        self._cols = torch.arange(pw, device=dev).view(1, 1, pw, 1)

    @staticmethod
    def tile_bytes(dataset) -> int:
        """Device bytes of the stacks: x and y in their held type, the f32
        reference and region canvases (device_cache.py:1428-1438)."""
        ph, pw = dataset.dslist[0].ds.grid.canvas_shape()
        nband = dataset.dslist[0].ds.raster_x.nband
        itemsize = oscd_held_dtype(dataset).itemsize
        return len(dataset) * ph * pw * (2 * nband * itemsize + 4 + 4)

    @staticmethod
    def supports(dataset) -> bool:
        """Whether the stacks of a non-empty list fit
        ``FCDGAN_TILE_CACHE_MAX_MB`` (device_cache.py:1414-1438)."""
        return bool(len(dataset)) and DeviceOSCDCache.tile_bytes(dataset) <= \
            _budget_mb("FCDGAN_TILE_CACHE_MAX_MB") * 1e6

    def complete(self, batch) -> dict:
        """An ``IndexBatchLoader`` batch -> NHWC f32 ``x``, ``y``, ``ref`` and
        ``region`` (B, ph, pw, 1), int64 ``item`` and f32 ``weight`` (the
        ``prep`` body, device_cache.py:1393-1412)."""
        item = torch.from_numpy(np.asarray(batch["item"], np.int64)).to(self.device)
        weight = torch.from_numpy(np.asarray(batch["weight"], np.float32)).to(self.device)
        win = self._wins[item].view(-1, 4, 1, 1, 1)
        x0, y0, ww, wh = win[:, 0], win[:, 1], win[:, 2], win[:, 3]
        mask = ((self._rows >= y0) & (self._rows < y0 + wh)
                & (self._cols >= x0) & (self._cols < x0 + ww))
        mx, sx, my, sy = (t[item][:, None, None, :] for t in self._norm)
        zero = torch.zeros((), device=self.device)
        x = torch.where(mask, (_take(self._xs, item).float() - mx) / sx, zero)
        y = torch.where(mask, (_take(self._ys, item).float() - my) / sy, zero)
        return {"x": x, "y": y, "ref": self._refs[item], "region": self._regions[item],
                "item": item, "weight": weight}

    def loader(self, batch_size: int, shuffle: bool = False,
               seed: int = 0) -> IndexBatchLoader:
        """Epoch batches over the tiles, for ``complete``."""
        return IndexBatchLoader(self.n_tiles, batch_size, shuffle=shuffle, seed=seed)
