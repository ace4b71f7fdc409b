"""Train and val sets resident on the card, batches gathered there (port of
``bbdm_tpu/data/device_cache.py``, ``training.device_data_cache``).

:class:`DeviceCachedLoader` decodes its loader's dataset once and keeps every
item on the device as NCHW-contiguous tensors in ``dtype`` (``float32`` or
``bfloat16``, ``training.device_cache_dtype``); the condition stream is
stored once when every item's x *is* its condition (``custom_single``). From
then on each batch costs an index vector's upload: the wrapped loader's own
``_indices()`` (the seeded shuffle, the node's shard) and this rank's
``rows`` of each batch (``data/loader.py``) pick the items, and the batch is
gathered on the device and cast to float32. So in float32 a batch equals
``runner._put_batch`` of the host loader's batch bit for bit, layout
included; in bfloat16 each value is rounded once, at storage, to nearest
even, as the JAX cache rounds it.

Differences from the JAX cache, none of which changes a batch:

* the decode runs on the loader's ``num_workers`` threads, in order in this
  thread when that is 0 or 1 (the JAX cache always uses a pool of 8, so a
  dataset built for one thread is read from several);
* each rank of a node keeps the whole set on its own card (the JAX cache
  replicates it over the mesh, ``P()``) and gathers its own rows, so a batch
  that does not split over the ranks raises in ``local_rows`` when the
  loader is built, as it does without the cache;
* one resident copy serves several loaders (``resident=``): the runner's
  latent-statistics pass and the train loader after it decode the set once.

Refused: a dataset with per-epoch draws (``set_epoch_seed``: its items
change every epoch, a snapshot would freeze them), and a set larger than
``BBDM_DEVICE_CACHE_MB`` (default 10240). Several nodes fall back to the host
loader with JAX's logged reason (:func:`maybe_device_cache`).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_DEFAULT_CAP_MB = 10240.0
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CHUNK = 64  # items decoded, stacked and uploaded at a time


class Resident:
    """A dataset's items on the device: ``x`` [N, C, H, W], ``cond`` (``x``
    itself for an identity stream), the name lists and the bytes held."""

    def __init__(self, dataset, device, dtype: str = "float32", num_workers: int = 0):
        if dtype not in _DTYPES:
            raise ValueError(f"device_cache_dtype {dtype!r}: one of {sorted(_DTYPES)}")
        self.device, self.dtype = torch.device(device), _DTYPES[dtype]
        cap = float(os.environ.get("BBDM_DEVICE_CACHE_MB", _DEFAULT_CAP_MB))
        n = len(dataset)
        self.x_names, self.cond_names = [], []
        self.x = self.cond = None
        identical = True
        pool = ThreadPoolExecutor(num_workers) if num_workers > 1 else None
        try:
            for lo in range(0, n, _CHUNK):
                ids = range(lo, min(lo + _CHUNK, n))
                items = list(pool.map(dataset.__getitem__, ids) if pool
                             else map(dataset.__getitem__, ids))
                xs = np.stack([x for (x, _), _ in items])
                if self.x is None:
                    self.x = self._allocate(n, xs.shape, cap, streams=1)
                self._store(self.x, lo, xs)
                same = [x is c for (x, _), (c, _) in items]
                if identical and not all(same):  # from here on two streams
                    identical = False
                    self.cond = self._allocate(n, xs.shape, cap, streams=2)
                    self.cond[:lo].copy_(self.x[:lo])
                if not identical:
                    self._store(self.cond, lo, np.stack([c for _, (c, _) in items]))
                self.x_names += [name for (_, name), _ in items]
                self.cond_names += [name for _, (_, name) in items]
        finally:
            if pool is not None:
                pool.shutdown()
        if identical:
            self.cond = self.x
        self.nbytes = (1 if identical else 2) * (self.x.numel() * self.x.element_size()
                                                 if self.x is not None else 0)

    def _allocate(self, n, chunk_shape, cap, streams):
        _, h, w, c = chunk_shape
        total = streams * n * c * h * w * torch.finfo(self.dtype).bits // 8
        if total > cap * 2**20:
            raise ValueError(
                f"device_data_cache would use {total / 2**20:.0f} MB of device memory "
                f"(> {cap:.0f} MB cap) — stream from host or raise BBDM_DEVICE_CACHE_MB")
        return torch.empty((n, c, h, w), dtype=self.dtype, device=self.device)

    def _store(self, dst, lo, nhwc: np.ndarray):
        """NHWC float32 items -> ``dst[lo:]``, NCHW in the storage dtype (rounded
        to nearest even once, on the device)."""
        t = torch.from_numpy(np.ascontiguousarray(nhwc, np.float32)).to(self.device)
        dst[lo:lo + len(nhwc)].copy_(t.permute(0, 3, 1, 2))


class DeviceCachedLoader:
    """The iteration contract of ``data.DataLoader`` (dicts of ``x``,
    ``x_cond`` and name lists), with ``x`` and ``x_cond`` float32 NCHW tensors
    gathered on ``device`` from the resident copy (``resident``, else decoded
    from ``loader.dataset`` here)."""

    def __init__(self, loader, device, dtype: str = "float32", resident: Resident = None):
        if hasattr(loader.dataset, "set_epoch_seed"):
            raise ValueError(
                "device_data_cache cannot snapshot a dataset with per-epoch randomness "
                "(set_epoch_seed) — disable training.device_data_cache for this dataset type")
        self.loader = loader
        self.device = torch.device(device)
        self.resident = resident or Resident(loader.dataset, self.device, dtype,
                                             loader.num_workers)
        if len(self.resident.x_names) != len(loader.dataset):
            raise ValueError(f"the resident copy holds {len(self.resident.x_names)} items, "
                             f"the dataset {len(loader.dataset)}")

    @property
    def dataset(self):
        return self.loader.dataset

    @property
    def device_bytes(self) -> int:
        return self.resident.nbytes

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        res, bs = self.resident, self.loader.batch_size
        idx = self.loader._indices()
        for b in range(len(self)):
            chunk = idx[b * bs:(b + 1) * bs][self.loader.rows]
            host = torch.from_numpy(chunk.astype(np.int64))
            if self.device.type == "cuda":  # a pageable copy would wait for the queued steps
                host = host.pin_memory()
            dev = host.to(self.device, non_blocking=True)
            yield {"x": res.x.index_select(0, dev).float(),
                   "x_name": [res.x_names[i] for i in chunk],
                   "x_cond": res.cond.index_select(0, dev).float(),
                   "x_cond_name": [res.cond_names[i] for i in chunk]}


def maybe_device_cache(loader, training_config, world, device, logger=print, resident=None):
    """``loader`` wrapped per ``training.device_data_cache`` (off by default).

    Several nodes fall back to the host loader with a logged reason; the
    refusals (per-epoch draws, the size cap) and a failed upload raise."""
    if not training_config.get("device_data_cache", False):
        return loader
    if world.nodes > 1:
        logger("device_data_cache: multi-host mesh -> host loader "
               "(global-batch assembly needs per-host numpy shards)")
        return loader
    dtype = training_config.get("device_cache_dtype", "float32")
    cached = DeviceCachedLoader(loader, device, dtype=dtype, resident=resident)
    if resident is None:
        logger(f"device_data_cache: {len(cached.dataset)} items "
               f"({cached.device_bytes / 2**20:.0f} MB {dtype}) resident on "
               "device; per-step host uploads reduced to index vectors")
    return cached
