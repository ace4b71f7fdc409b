"""The train state (port of ``bbdm_tpu/training/state.py``).

``step`` counts microbatches like the reference's ``global_step``; the
parameters are the model's own (``params`` names its trainable ones), and
their ``.grad`` is the gradient accumulator: autograd sums each microbatch's
gradient into it, as the reference's ``loss.backward()`` does (it does not
divide by ``accumulate_grad_batches``), until the update clears it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from bbdm_tpu_torch.training.optim import Optimizer
from bbdm_tpu_torch.training.plateau import PlateauState


@dataclass
class TrainState:
    step: int  # microbatch counter (== the reference's global_step)
    params: dict  # {state_dict name: parameter}, the trainable ones
    ema: Optional[dict]  # {name: fp32 shadow} of params, under EMA.use_ema
    optimizer: Optimizer
    plateau: PlateauState
    latent_stats: Optional[dict] = None  # LBBDM normalize_latent stats, [1, C, 1, 1]
    sharding: Optional[object] = None  # parallel.sharding.ShardedState, when sharded
