"""The collectives of data-parallel training and sampling (the role of
``bbdm_tpu/parallel/mesh.py``: there GSPMD inserts them, here they are
written out).

Each rank takes its own rows of each global batch, the rows of its data index
on the grid (``parallel/mesh.py``; the ranks of one model group take the same
rows). A run on N ranks computes what one rank computes over the same global
batch:

* per-sample draws (:func:`randn`, :func:`rand`, :func:`randint`) come from
  generators seeded alike on every rank, at the global batch's shape, and each
  rank keeps its data index's rows, as a draw under ``jit`` fills the global
  array and each device holds its shard;
* gradients and losses are means over the data group (:func:`all_reduce_mean_`,
  :func:`mean`): each rank's loss is the mean over its rows, and the ranks
  hold equal numbers of rows;
* train-mode BatchNorm takes its statistics over the global batch
  (:func:`batch_mean`, with gradient through the reduction).

:func:`all_gather`, :func:`reduce_scatter_mean` and :func:`all_reduce_sum`
work along one dimension over either axis of the grid (FSDP and tensor
parallelism, ``parallel/sharding.py`` and ``parallel/tensor.py``). They use
the list forms of ``torch.distributed``'s calls, which NCCL and gloo run on
card and host tensors alike in the torch versions the port meets (the tensor
forms are deprecated in newer ones); gloo stages card tensors through the
host itself. Reductions of 16-bit tensors run in fp32.

Without a process group every function is the identity or a no-op; in a
group of one rank the collectives still run (the one-rank NCCL group of a
one-node multi-node run exercises them).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from bbdm_tpu_torch.parallel.distributed import host_group, world
from bbdm_tpu_torch.parallel.mesh import grid

_rank_local = False  # draws of this rank alone (see rank_local)


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
    """``fn(shape)`` at the global batch's shape, this rank's data index's rows of it."""
    g = grid()
    if g.data_size == 1 or _rank_local:
        return fn(tuple(shape))
    full = fn((shape[0] * g.data_size, *shape[1:]))
    return full[local_rows(full.shape[0], g.data_index, g.data_size)]


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
    """Each tensor replaced, in place, by its mean over the data group: one
    collective over a flat fp32 buffer in the list's order."""
    if not _grouped() or not tensors:
        return
    g = grid()
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=g.data_group)
    flat /= g.data_size
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data group (no gradient), a new tensor."""
    if not _grouped():
        return x
    g = grid()
    x = x.detach().clone()
    dist.all_reduce(x, group=g.data_group)
    return x / g.data_size


class _BatchMean(torch.autograd.Function):
    """Forward: the mean over the data group. Backward: the mean over it of the
    incoming gradients, which, with the ranks' gradients then averaged, gives
    each rank its share of the global loss's gradient through the statistics."""

    @staticmethod
    def forward(ctx, x):
        return mean(x)

    @staticmethod
    def backward(ctx, g):
        return mean(g.contiguous())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data group of per-rank batch statistics, differentiable."""
    return _BatchMean.apply(x) if _grouped() else x


def all_gather(x: torch.Tensor, dim: int = 0, axis: str = "data") -> torch.Tensor:
    """The ranks of ``axis`` (``"data"`` or ``"model"``)'s ``x``, concatenated
    along ``dim`` in their order (a new tensor)."""
    group, size, _ = grid().axis(axis)
    if size == 1:
        return x.clone()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_scatter_mean(x: torch.Tensor, dim: int = 0, axis: str = "data") -> torch.Tensor:
    """This rank's part along ``dim`` of the mean over the ranks of ``axis`` of
    ``x`` (``dim`` split in equal parts, one per rank, in their order), in x's dtype."""
    group, size, index = grid().axis(axis)
    if size == 1:
        return x.clone()
    parts = [p.float().contiguous() for p in x.chunk(size, dim)]
    out = torch.empty_like(parts[index])
    dist.reduce_scatter(out, parts, group=group)
    return (out / size).to(x.dtype)


def all_reduce_sum(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum over the ranks of ``axis`` of ``x``, in x's dtype (a new tensor)."""
    group, size, _ = grid().axis(axis)
    if size == 1:
        return x.clone()
    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


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
