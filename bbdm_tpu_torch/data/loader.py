"""Host-side batching loader with a prefetch thread (port of
``bbdm_tpu/data/loader.py:53-155``).

Per-epoch shuffling with ``np.random.RandomState(seed + epoch)``, full batches
only (the last partial batch is dropped, as every loader of
``bbdm_tpu/runners/base.py:359-377`` does), and batches as dicts of NHWC
float32 arrays plus name lists::

    {"x": [B, H, W, C], "x_name": [B], "x_cond": [B, H, W, C], "x_cond_name": [B]}

Data parallelism (``parallel/``): node ``shard_index`` of ``shard_count``
takes the JAX loader's shard of the shuffled indices (padded to a multiple of
``shard_count`` with its first indices, as DistributedSampler pads, then every
``shard_count``-th from ``shard_index``) in batches of ``batch_size``, and
rank ``local_index`` of the node's ``local_count`` keeps its contiguous rows
of each of them: it decodes only those. The union of a node's ranks' rows is
the node's batch, row for row.

A background thread prepares the next two batches while the caller works on
the current one; an error there is raised to the caller. It decodes each
batch's items on ``num_workers`` threads (default ``min(8, os.cpu_count())``,
as ``bbdm_tpu/data/loader.py:76-84``; 0 or 1: in that thread), in order, so
the batches are the same for any ``num_workers``. The host library releases
the GIL while it decodes, and so does ``zlib``. ``dataset.__getitem__`` is
therefore called from several threads at once: the datasets keep no state
that an item changes. ``set_epoch`` reseeds a dataset's per-epoch draws (the
inpainting boxes) through its ``set_epoch_seed``, between epochs.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from bbdm_tpu_torch.parallel.collectives import local_rows


def _collate(items) -> dict:
    return {
        "x": np.stack([x for (x, _), _ in items]).astype(np.float32, copy=False),
        "x_name": [n for (_, n), _ in items],
        "x_cond": np.stack([c for _, (c, _) in items]).astype(np.float32, copy=False),
        "x_cond_name": [n for _, (_, n) in items],
    }


class DataLoader:
    prefetch = 2  # batches decoded ahead

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                 shard_count: int = 1, shard_index: int = 0, local_count: int = 1,
                 local_index: int = 0, num_workers: int | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_count, self.shard_index = shard_count, shard_index
        self.rows = local_rows(batch_size, local_index, local_count)  # raises if uneven
        if num_workers is None:
            num_workers = min(8, os.cpu_count() or 1)
        self.num_workers = max(0, int(num_workers))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Shuffle for ``epoch``; reseed the dataset's per-epoch draws."""
        self.epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch_seed"):
            self.dataset.set_epoch_seed(self.seed + self.epoch)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.shard_count > 1:
            idx = np.concatenate([idx, idx[:(-len(idx)) % self.shard_count]])
            idx = idx[self.shard_index::self.shard_count]
        return idx

    def __len__(self) -> int:
        return len(self._indices()) // self.batch_size

    def _batches(self) -> Iterator[dict]:
        idx = self._indices()
        chunks = (idx[b * self.batch_size:(b + 1) * self.batch_size][self.rows].tolist()
                  for b in range(len(self)))
        if self.num_workers <= 1:
            for chunk in chunks:
                yield _collate([self.dataset[i] for i in chunk])
            return
        with ThreadPoolExecutor(self.num_workers, thread_name_prefix="bbdm-decode") as pool:
            for chunk in chunks:  # map keeps the order and raises an item's error
                yield _collate(list(pool.map(self.dataset.__getitem__, chunk)))

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()
        err = []

        def worker():
            try:
                for batch in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # handed to the consumer below
                err.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True, name="bbdm-loader")
        t.start()
        try:
            while (item := q.get()) is not done:
                yield item
            if err:
                raise err[0]
        finally:
            stop.set()
            while t.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
