"""Host-side batching loader with a prefetch thread (port of
``bbdm_tpu/data/loader.py:53-155``, one process, no sharding).

Per-epoch shuffling with ``np.random.RandomState(seed + epoch)``, full batches
only (the last partial batch is dropped, as every loader of
``bbdm_tpu/runners/base.py:359-377`` does), and batches as dicts of NHWC
float32 arrays plus name lists::

    {"x": [B, H, W, C], "x_name": [B], "x_cond": [B, H, W, C], "x_cond_name": [B]}

A background thread decodes the next two batches while the caller works on the
current one; an error there is raised to the caller.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def _collate(items) -> dict:
    return {
        "x": np.stack([x for (x, _), _ in items]).astype(np.float32),
        "x_name": [n for (_, n), _ in items],
        "x_cond": np.stack([c for _, (c, _) in items]).astype(np.float32),
        "x_cond_name": [n for _, (_, n) in items],
    }


class DataLoader:
    prefetch = 2  # batches decoded ahead

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _batches(self) -> Iterator[dict]:
        idx = self._indices()
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield _collate([self.dataset[int(i)] for i in chunk])

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
