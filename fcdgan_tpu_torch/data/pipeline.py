"""Host batches: fixed shapes, wrap padding, a background prefetch queue.

Copy of the JAX package's ``data/pipeline.py`` (``Batch``, ``BatchLoader``,
``prefetch``, :24-115, 141-165). ``BatchLoader`` yields fixed-shape
weighted batches of a dataset's tuple fields: the tail is wrap-padded from
the epoch's own order with weight 0 (``tail='pad'``) or yielded short
(``tail='short'``, the reference's ``drop_last=False``). The numpy shuffle
is seeded, so a seed gives the JAX package's batch order. ``prefetch`` runs
an iterator on a background thread into a bounded queue, so tile reads and
assembly overlap the device. The pair loader and the native C++ loaders are
not ported (ROADMAP.md, queue A).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np


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
