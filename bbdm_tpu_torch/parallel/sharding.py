"""FSDP and tensor-parallel placement of the train state: the port's copy of
``bbdm_tpu/parallel/tp.py``.

Sharding is only a layout: a step on a ``data x model`` grid of ranks
(``parallel/mesh.py``) computes what one rank computes over the same global
batch, and each rank keeps about 1/N of each leaf it splits over N ranks.

The rule is the JAX package's (:func:`leaf_spec`), applied to each leaf's JAX
shape: ``training.model_parallel`` puts ``model`` on the last dimension of a
leaf of two or more dimensions where the width divides it (a conv kernel's or
a dense kernel's output features); ``training.fsdp`` puts ``data`` on the
largest remaining dimension the data width divides, the earliest on ties
(biases on their only one). The JAX layouts are the transposes of
``checkpoints/from_jax.py``: conv ``[kh, kw, I, O]`` is the port's ``[O, I,
kh, kw]``, dense ``[I, O]`` its ``[O, I]``; every other leaf keeps its shape.
:func:`placement` maps the axes back to torch dimensions, where the ties fall
elsewhere (a 512 -> 512 conv shards ``I`` under FSDP, not ``O``).

:func:`place_state` turns a runner's model and train state into shards:
every parameter (the frozen VQGAN's too), the discriminator's BatchNorm
statistics, the optimizers' moments, the EMA, and a gradient accumulator.
Scalars stay whole. The :class:`ShardedState` it returns moves leaves between
three forms:

* **shard**, between steps: this rank's block of each leaf;
* **step** (:meth:`ShardedState.step_form`): every leaf gathered over the data
  axis, and over the model axis too but for the weights of the column-parallel
  layers (``parallel/tensor.py``), which keep their model shard;
* **full** (:meth:`ShardedState.gathered`): every leaf whole, the moments and
  the EMA too, for sampling, validation and checkpoints. It is a collective:
  every rank enters it.

After a step's backward, :meth:`ShardedState.reduce` takes each gradient to
its shard and averages it over the data group (one reduce-scatter for the
data-sharded leaves, one all-reduce for the others). Each gather and reduction
is one collective per axis over a flat buffer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from bbdm_tpu_torch.parallel import collectives
from bbdm_tpu_torch.parallel.mesh import Grid, grid


def leaf_spec(shape, model_size: int, fsdp_size: int = 1) -> tuple:
    """The mesh axis (``"model"``, ``"data"`` or None) of each dimension of a
    leaf of JAX shape ``shape`` (``bbdm_tpu/parallel/tp.py:46-68``; () where
    it is not split)."""
    ndim = len(shape)
    if not ndim:
        return ()
    axes = [None] * ndim
    if model_size > 1 and ndim >= 2 and shape[-1] % model_size == 0 \
            and shape[-1] >= model_size:
        axes[-1] = "model"
    if fsdp_size > 1:
        candidates = [d for d in range(ndim)
                      if axes[d] is None and shape[d] % fsdp_size == 0 and shape[d] >= fsdp_size]
        if candidates:
            axes[max(candidates, key=lambda d: shape[d])] = "data"
    return tuple(axes) if any(axes) else ()


def jax_dims(name: str, ndim: int) -> tuple:
    """The torch dimension of each JAX dimension of leaf ``name``: a conv
    kernel ``[kh, kw, I, O]`` is ``weight`` ``[O, I, kh, kw]``, a dense kernel
    ``[I, O]`` is ``weight`` ``[O, I]`` (``checkpoints/from_jax.py``)."""
    if name.rsplit(".", 1)[-1] == "weight":
        if ndim == 4:
            return (2, 3, 1, 0)
        if ndim == 2:
            return (1, 0)
    return tuple(range(ndim))


@dataclasses.dataclass(frozen=True)
class Placement:
    """The torch dimensions split over the model and the data axis (None: whole)."""
    model: Optional[int] = None
    data: Optional[int] = None


def placement(name: str, shape, model_size: int, fsdp_size: int = 1) -> Placement:
    """:func:`leaf_spec` on the JAX shape of leaf ``name``, in torch dimensions."""
    dims = jax_dims(name, len(shape))
    spec = leaf_spec([shape[d] for d in dims], model_size, fsdp_size)
    where = {axis: dims[j] for j, axis in enumerate(spec) if axis is not None}
    return Placement(where.get("model"), where.get("data"))


def _narrow(t: torch.Tensor, dim: Optional[int], size: int, index: int) -> torch.Tensor:
    if dim is None:
        return t
    k = t.shape[dim] // size
    return t.narrow(dim, index * k, k)


def _flat_gather(tensors: list, dims: list, axis: str, size: int) -> list:
    """Each tensor concatenated along its dim with its peers' on ``axis``:
    one all-gather of a flat buffer per dtype."""
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        rows = collectives.all_gather(flat[None], 0, axis)  # [size, n]
        offset = 0
        for i in idx:
            t, d = tensors[i], dims[i]
            parts = rows[:, offset:offset + t.numel()].reshape(size, *t.shape)
            out[i] = parts.movedim(0, d).reshape(*t.shape[:d], size * t.shape[d],
                                                 *t.shape[d + 1:])
            offset += t.numel()
    return out


def _flat_reduce_scatter(tensors: list, dims: list, axis: str, size: int) -> list:
    """Each tensor's part along its dim of its fp32 mean over ``axis``: one
    reduce-scatter of a flat [size, n] buffer."""
    rows = torch.cat([t.float().unflatten(d, (size, t.shape[d] // size)).movedim(d, 0)
                      .reshape(size, -1) for t, d in zip(tensors, dims)], 1)
    mine = collectives.reduce_scatter_mean(rows, 0, axis)[0]
    out, offset = [], 0
    for t, d in zip(tensors, dims):
        shape = (*t.shape[:d], t.shape[d] // size, *t.shape[d + 1:])
        n = math.prod(shape)
        out.append(mine[offset:offset + n].view(shape))
        offset += n
    return out


@dataclasses.dataclass
class _Leaf:
    place: Placement
    column: bool  # a column-parallel layer's weight: its step form keeps the model shard


class ShardedState:
    """The shards of a model and its train state on this rank (see the module
    docstring). ``modules``: {name: parameter or buffer}, whose storage
    (``.data``) is swapped between forms; ``state``: (container, key, name)
    of each optimizer moment and EMA tensor, the leaf of parameter ``name``,
    replaced in its container."""

    def __init__(self, g: Grid, leaves: dict, modules: dict, state: list):
        self.grid = g
        self.leaves = leaves  # name -> _Leaf
        self.modules = modules
        self.state = state
        self._by_param = {id(p): n for n, p in modules.items()}
        for n, t in modules.items():
            t.data = self.shard(n, t.data)
        for container, key, n in state:
            container[key] = self.shard(n, container[key])
        self.accum: Optional[list] = None  # the train step's gradient sums, when it keeps them

    # ------------------------------------------------------------- layouts

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``name``."""
        p, g = self.leaves[name].place, self.grid
        t = _narrow(_narrow(full, p.model, g.model_size, g.model_index),
                    p.data, g.data_size, g.data_index)
        return t.clone(memory_format=torch.contiguous_format)

    def _gather(self, names: list, tensors: list, keep_column: bool) -> list:
        """``tensors`` (the shards of ``names``) gathered over the data axis, then
        over the model axis but for the column weights where ``keep_column``."""
        out = list(tensors)
        for axis, size in (("data", self.grid.data_size), ("model", self.grid.model_size)):
            idx = [i for i, n in enumerate(names)
                   if getattr(self.leaves[n].place, axis) is not None
                   and not (axis == "model" and keep_column and self.leaves[n].column)]
            if size > 1 and idx:
                done = _flat_gather([out[i] for i in idx],
                                    [getattr(self.leaves[names[i]].place, axis) for i in idx],
                                    axis, size)
                for i, t in zip(idx, done):
                    out[i] = t
        return out

    def _swap_modules(self, keep_column: bool) -> list:
        names = list(self.modules)
        saved = [self.modules[n].data for n in names]
        for n, t in zip(names, self._gather(names, saved, keep_column)):
            self.modules[n].data = t
        return saved

    def _restore_modules(self, saved: list) -> None:
        """The shards back: the parameters' own, the buffers' cut anew from the
        values the block left (BatchNorm moves its statistics)."""
        for (n, t), s in zip(self.modules.items(), saved):
            if isinstance(t, nn.Parameter):
                t.grad = None
                t.data = s
            else:  # 1-D: whole in the step form too
                t.data = self.shard(n, t.data)

    # --------------------------------------------------------------- forms

    @contextlib.contextmanager
    def step_form(self):
        """The leaves in their step form for the block (a collective)."""
        saved = self._swap_modules(keep_column=True)
        try:
            yield
        finally:
            self._restore_modules(saved)

    @contextlib.contextmanager
    def gathered(self):
        """Every leaf whole for the block, the optimizers' moments and the EMA
        too (a collective: every rank enters it)."""
        saved = self._swap_modules(keep_column=False)
        shards = [c[k] for c, k, _ in self.state]
        for (c, k, _), t in zip(self.state, self._gather([n for _, _, n in self.state],
                                                         shards, keep_column=False)):
            c[k] = t
        try:
            yield
        finally:
            for (c, k, _), s in zip(self.state, shards):
                c[k] = s
            self._restore_modules(saved)

    # --------------------------------------------------------------- grads

    def reduce(self, params: list, grads: list) -> list:
        """The gradients (step form) of ``params`` as fp32 shards averaged over
        the data group."""
        g = self.grid
        names = [self._by_param[id(p)] for p in params]
        grads = [_narrow(t, self.leaves[n].place.model, g.model_size, g.model_index)
                 if not self.leaves[n].column else t for n, t in zip(names, grads)]
        out = [None] * len(grads)
        split = [i for i, n in enumerate(names) if self.leaves[n].place.data is not None]
        whole = [i for i, n in enumerate(names) if self.leaves[n].place.data is None]
        if split:  # FSDP: the data width is above 1
            done = _flat_reduce_scatter([grads[i] for i in split],
                                        [self.leaves[names[i]].place.data for i in split],
                                        "data", g.data_size)
            for i, t in zip(split, done):
                out[i] = t
        if whole:
            mine = [grads[i].float() for i in whole]  # averaged in place
            collectives.all_reduce_mean_(mine)
            for i, t in zip(whole, mine):
                out[i] = t
        return out

    def whole(self, params: list, shards: list) -> list:
        """The shards of ``params``' leaves (e.g. what :meth:`reduce` returns)
        made whole (a collective)."""
        return self._gather([self._by_param[id(p)] for p in params], shards, keep_column=False)

    def persistent_bytes(self) -> int:
        """Bytes this rank keeps between steps: the shards of the parameters,
        buffers, moments and EMA, and the gradient accumulator."""
        return (sum(t.data.nbytes for t in self.modules.values())
                + sum(c[k].nbytes for c, k, _ in self.state)
                + sum(a.nbytes for a in self.accum or ()))


def _column_weights(model: nn.Module) -> set:
    from bbdm_tpu_torch.models.layers import Conv2d, Dense, UpsampleConv3x3

    return {f"{m}.weight" if m else "weight" for m, mod in model.named_modules()
            if isinstance(mod, (Conv2d, Dense, UpsampleConv3x3))}


def _state_tensors(state) -> list:
    """(optimizer, EMA dict or None) pairs of a TrainState or GANTrainState."""
    if hasattr(state, "optimizer"):
        return [(state.optimizer, state.ema)]
    return [(state.gen_opt, None), (state.disc_opt, None)]


def place_state(model: nn.Module, state, *, model_parallel: int = 1,
                fsdp: bool = False) -> Optional[ShardedState]:
    """Shard ``model`` and ``state`` (a TrainState or a GANTrainState) over the
    active grid (``bbdm_tpu/parallel/tp.py:71-85``). None where nothing is
    split: no model axis and no FSDP over more than one rank (JAX replicates)."""
    from bbdm_tpu_torch.models.discriminator import BatchNorm2d

    g = grid()
    if g.model_size != model_parallel:
        raise ValueError(f"the active grid has model width {g.model_size}, the state asks "
                         f"for model_parallel={model_parallel}")
    fsdp_size = g.data_size if fsdp else 1
    if model_parallel <= 1 and fsdp_size <= 1:
        return None
    modules = dict(model.named_parameters())
    for m, mod in model.named_modules():
        if isinstance(mod, BatchNorm2d):
            modules.update({f"{m}.{b}": t for b, t in mod.named_buffers(recurse=False)})
    columns = _column_weights(model)
    leaves = {n: _Leaf(placement(n, t.shape, model_parallel, fsdp_size), n in columns)
              for n, t in modules.items()}
    name_of = {id(p): n for n, p in modules.items()}
    tensors = []
    for opt, ema in _state_tensors(state):
        names = [name_of[id(p)] for p in opt.params]
        for key, value in opt.state.items():
            if isinstance(value, list):
                tensors += [(value, i, n) for i, n in enumerate(names)]
        if ema is not None:
            by_name = {name_of[id(p)]: k for k, p in state.params.items()}
            tensors += [(ema, by_name[n], n) for n in names]
    return ShardedState(g, leaves, modules, tensors)
