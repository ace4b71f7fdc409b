"""Column-parallel layers: the model axis of the grid (``parallel/mesh.py``).

Under ``training.model_parallel`` > 1 a conv or dense weight whose output
dimension (torch dim 0, the JAX kernel's last) the width divides is held as
this rank's rows (``parallel/sharding.py``). ``models/layers.py``'s
``Conv2d``, ``Dense`` and ``UpsampleConv3x3`` (training form) then compute
their own output channels and gather them along the channel axis over the
model group, the Megatron pair:

* before the layer, :class:`_ToModel`: the identity, whose backward sums the
  input's gradient over the model group (each rank's part comes from its own
  output channels);
* after it, :class:`_FromModel`: the all-gather along the channel axis, whose
  backward keeps this rank's slice of the incoming gradient (the same on
  every model peer), with no communication.

The bias is 1-D, so it stays whole, and the layer adds it after the gather.
Everything after the gather (K1, K3, the losses) sees the full activations.
"""

from __future__ import annotations

import torch

from bbdm_tpu_torch.parallel import collectives
from bbdm_tpu_torch.parallel.mesh import grid


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce_sum(g, "model")


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim):
        ctx.dim = dim
        return collectives.all_gather(y, dim, "model")

    @staticmethod
    def backward(ctx, g):
        _, size, index = grid().axis("model")
        return g.chunk(size, ctx.dim)[index].contiguous(), None


def is_shard(weight: torch.Tensor, out_features: int) -> bool:
    """Whether ``weight`` holds only this rank's rows of ``out_features``."""
    return weight.shape[0] != out_features


def column_parallel(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(x)`` (this rank's output channels, no bias) gathered along ``dim``
    over the model group, with the input's gradient summed over it."""
    return _FromModel.apply(fn(_ToModel.apply(x)), dim)
