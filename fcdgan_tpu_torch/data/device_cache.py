"""Device-resident scene pair: training batches and the stitched density.

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
finished raster is downloaded once.

Chunks are batch-exact: ``ceil(n / batch_size)`` chunks of ``batch_size``
tiles, the last one wrap-padded with the first tiles again (their interiors
are re-written with identical values). Scenes past ``fits()`` need the
rolling-window cache, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .normalize import Normalize

# bytes the resident raw scene pair may take on the device;
# rasters are held as float32 there
SCENE_CACHE_MAX_BYTES = 4096 * 10**6


class IndexBatchLoader:
    """Epoch iterator of (item, weight) batches (JAX ``IndexBatchLoader``
    with the order logic of its base ``BatchLoader``, pipeline.py:41-107):
    a seeded numpy shuffle of ``n_items`` ids per epoch, so the same seed
    gives the JAX package's batch order, and the last partial batch at its true size (the
    reference's ``drop_last=False``, JAX ``tail='short'``). The wrap-padded
    tail (``tail='pad'``) is not ported."""

    def __init__(self, n_items: int, batch_size: int, shuffle: bool = False,
                 seed: int = 0):
        self.n = n_items
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, self.n, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield {"item": idx.astype(np.int64), "weight": np.ones(len(idx), np.float32)}


def serve_chunks(n: int, bs: int) -> np.ndarray:
    """(n_chunks, bs_eff) tile ids, wrap-padded (device_cache.py:991-1009
    with ``FCDGAN_SERVE_BS`` unset)."""
    bs_eff = min(bs, n)
    nc = -(-n // bs_eff)
    return np.resize(np.arange(n, dtype=np.int64), nc * bs_eff).reshape(nc, bs_eff)


class DeviceSceneCache:
    """Raw scene pair resident on ``device`` + gathered, normalized tiles."""

    def __init__(self, dataset, normalize, device):
        if not self.fits(dataset):
            raise NotImplementedError(
                "scene exceeds the device-resident cache budget "
                f"({SCENE_CACHE_MAX_BYTES / 1e6:.0f} MB); rolling-window serving "
                "(DeviceSceneWindowCache) is not ported yet (ROADMAP.md, queue A)")
        if not isinstance(normalize, Normalize):
            raise ValueError("DeviceSceneCache needs a Normalize enhance")
        grid = dataset.grid
        self.grid = grid
        self.device = torch.device(device)
        hp, wp = grid.padded_shape()
        padx, pady = grid.overlap_padding
        nband = dataset.raster_x.nband

        def padded(raster):
            out = np.zeros((hp, wp, raster.nband), np.float32)
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
        stats = (normalize.meansX, normalize.stdX, normalize.meansY, normalize.stdY)
        self._norm = [torch.tensor(s[:nband], dtype=torch.float32, device=self.device)
                      for s in stats]

    @staticmethod
    def fits(dataset) -> bool:
        hp, wp = dataset.grid.padded_shape()
        rasters = (dataset.raster_x, dataset.raster_y, dataset.raster_ref)
        bands = sum(r.nband for r in rasters if r is not None)
        return hp * wp * bands * 4 <= SCENE_CACHE_MAX_BYTES

    def _gather(self, ids: torch.Tensor, with_ref: bool = False):
        """NHWC f32 tiles of ``ids``: normalized x and y, zero outside each
        write window, and the raw reference tile (the ``prep`` body,
        device_cache.py:87-123)."""
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
        x = torch.where(mask, (self.px[rows, cols] - mx) / sx, zero)
        y = torch.where(mask, (self.py[rows, cols] - my) / sy, zero)
        if not with_ref:
            return x, y, None
        if self.pref is None:
            ref = torch.zeros((len(ids), ph, pw, 1), device=self.device)
        else:
            ref = self.pref[rows, cols]
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
    def stitched_density(self, model, batch_size: int = 10) -> np.ndarray:
        """Whole-scene (ysize, xsize) float32 density: one device canvas,
        disjoint interior writes, one download (device_cache.py:125-154)."""
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
        return canvas[:hs, :ws].cpu().numpy()
