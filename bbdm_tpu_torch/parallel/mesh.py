"""The grid of ranks: the port's counterpart of the ``('data', 'model')`` mesh
of ``bbdm_tpu/parallel/mesh.py:27-35``.

The world's ranks form a ``size // model_parallel`` x ``model_parallel``
grid, in the order JAX's ``devices.reshape(n // model_parallel,
model_parallel)`` gives: rank ``r`` has data index ``r // model_parallel``
and model index ``r % model_parallel``. The ranks of one model index form a
*data group* (they take different rows of each batch and average their
gradients); the ranks of one data index form a *model group* (they take the
same rows and hold different shards of the tensor-parallel weights, see
``parallel/tensor.py``). A model group lies inside one node.

:func:`make_grid` builds the grid over the current process group and makes it
the active one; :func:`grid` reads it. Without ``model_parallel`` > 1 the data
group is the whole world and no group is made. Without a process group the
grid is 1 x 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from bbdm_tpu_torch.parallel.distributed import World, world


@dataclasses.dataclass(frozen=True)
class Grid:
    world: World
    data_size: int
    model_size: int = 1
    data_group: Optional[object] = None  # None: the whole world
    model_group: Optional[object] = None

    @property
    def data_index(self) -> int:
        return self.world.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.world.rank % self.model_size

    def axis(self, name: str) -> tuple:
        """(process group, size, this rank's index) of axis ``"data"`` or ``"model"``."""
        if name == "data":
            return self.data_group, self.data_size, self.data_index
        if name == "model":
            return self.model_group, self.model_size, self.model_index
        raise ValueError(f"no mesh axis {name!r}")


_grids: dict = {}  # model_parallel -> Grid, for the world they were made in
_active: Optional[Grid] = None


def grid() -> Grid:
    """The active grid of the current world (data parallel over every rank
    where :func:`make_grid` was not called since the world was joined)."""
    w = world()
    if _active is not None and _active.world is w:
        return _active
    return Grid(w, w.size)


def make_grid(model_parallel: int = 1) -> Grid:
    """The grid of width ``model_parallel`` over the current world, made active.
    Every rank calls it, in the same order (it makes process groups). Raises
    ValueError when ``model_parallel`` does not divide the number of ranks, or,
    on several nodes, the ranks of a node."""
    global _active, _grids
    w = world()
    n, mp = w.size, int(model_parallel)
    if mp < 1 or n % mp:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    if w.nodes > 1 and w.local_size % mp:
        raise ValueError(f"model_parallel={mp} does not divide the {w.local_size} ranks of a "
                         "node: a model group must lie inside one node")
    if _grids and next(iter(_grids.values())).world is not w:
        _grids = {}
    if mp not in _grids:
        if mp == 1:
            g = Grid(w, n)
        else:
            rows = n // mp
            data = [dist.new_group([d * mp + m for d in range(rows)]) for m in range(mp)]
            model = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(rows)]
            g = Grid(w, rows, mp, data[w.rank % mp], model[w.rank // mp])
        _grids[mp] = g
    _active = _grids[mp]
    return _active
