"""The collectives of data-parallel training and sampling (the role of
``bbdm_tpu/parallel/mesh.py``: there GSPMD inserts them, here they are
written out).

Every rank holds the same weights and takes its own rows of each global batch.
A run on N ranks computes what one rank computes over the same global batch:

* per-sample draws (:func:`randn`, :func:`rand`, :func:`randint`) come from
  generators seeded alike on every rank, at the global batch's shape, and each
  rank keeps its rows, as a draw under ``jit`` fills the global array and each
  device holds its shard;
* gradients and losses are means over ranks (:func:`all_reduce_mean_`,
  :func:`mean`): each rank's loss is the mean over its rows, and the ranks
  hold equal numbers of rows;
* train-mode BatchNorm takes its statistics over the global batch
  (:func:`batch_mean`, with gradient through the reduction).

Without a process group every function is the identity or a no-op; in a
group of one rank the collectives still run (the one-rank NCCL group of a
one-node multi-node run exercises them).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from bbdm_tpu_torch.parallel.distributed import host_group, world

_rank_local = False  # draws of this rank alone (see rank_local)


def _size() -> int:
    return world().size


def _grouped() -> bool:
    return world().backend is not None


def local_rows(n: int, index: int, count: int) -> slice:
    """Rows ``[index * n / count, (index + 1) * n / count)`` of ``n``: the
    ``index``-th of ``count`` equal parts; raises when ``count`` does not
    divide ``n``."""
    if n % count:
        raise ValueError(f"a batch of {n} rows does not split over {count} ranks")
    part = n // count
    return slice(index * part, (index + 1) * part)


@contextlib.contextmanager
def rank_local():
    """Draws at this rank's own shape: for work one rank does alone (the
    mid-training sample grids of rank 0), which then draws what a one-rank
    run draws for the same call."""
    global _rank_local
    saved, _rank_local = _rank_local, True
    try:
        yield
    finally:
        _rank_local = saved


def _draw(fn, shape):
    """``fn(shape)`` at the global batch's shape, this rank's rows of it."""
    w = world()
    if w.size == 1 or _rank_local:
        return fn(tuple(shape))
    full = fn((shape[0] * w.size, *shape[1:]))
    return full[local_rows(full.shape[0], w.rank, w.size)]


def randn(shape, *, generator=None, dtype=None, device=None) -> torch.Tensor:
    return _draw(lambda s: torch.randn(s, generator=generator, dtype=dtype, device=device),
                 shape)


def rand(shape, *, generator=None, dtype=None, device=None) -> torch.Tensor:
    return _draw(lambda s: torch.rand(s, generator=generator, dtype=dtype, device=device),
                 shape)


def randint(low: int, high: int, shape, *, generator=None, device=None) -> torch.Tensor:
    return _draw(lambda s: torch.randint(low, high, s, generator=generator, device=device),
                 shape)


@torch.no_grad()
def all_reduce_mean_(tensors: list) -> None:
    """Each tensor replaced, in place, by its mean over ranks: one collective
    over a flat fp32 buffer in the list's order."""
    if not _grouped() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= _size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over ranks (no gradient), a new tensor."""
    if not _grouped():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / _size()


class _BatchMean(torch.autograd.Function):
    """Forward: the mean over ranks. Backward: the mean over ranks of the
    incoming gradients, which, with the ranks' gradients then averaged, gives
    each rank its share of the global loss's gradient through the statistics."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y / _size()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g / _size()


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of per-rank batch statistics, differentiable."""
    return _BatchMean.apply(x) if _grouped() else x


@torch.no_grad()
def broadcast_(tensors: list, src: int = 0) -> None:
    """Rank ``src``'s values into ``tensors`` on every rank, one collective per dtype."""
    if not _grouped():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers into ``module`` on every rank."""
    broadcast_([*module.parameters(), *module.buffers()], src)


def broadcast_flag(flag: bool, src: int = 0) -> bool:
    """Rank ``src``'s ``flag`` on every rank (on the host)."""
    if not _grouped():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.broadcast(t, src, group=host_group())
    return bool(t.item())


def barrier() -> None:
    if _grouped():
        dist.barrier(group=host_group())
