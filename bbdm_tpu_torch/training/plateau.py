"""ReduceLROnPlateau as a state transition on the device
(port of ``bbdm_tpu/training/plateau.py``).

torch's ``ReduceLROnPlateau(mode='min', threshold_mode='rel')`` stepped with the
training loss of each optimizer update: better <=> metric < best * (1 -
threshold); in cooldown the cooldown counter ticks and bad steps are not
counted; after ``patience`` consecutive bad steps lr <- max(lr * factor,
min_lr) and the cooldown starts. The state is four 0-d tensors on the device
and the transition is ``torch.where`` over them, so stepping it reads nothing
back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class PlateauState:
    lr: torch.Tensor  # f32 scalar
    best: torch.Tensor  # f32 scalar
    num_bad: torch.Tensor  # i32 scalar
    cooldown_count: torch.Tensor  # i32 scalar


def plateau_init(lr: float, device=None) -> PlateauState:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return PlateauState(lr=torch.tensor(lr, **f32), best=torch.tensor(float("inf"), **f32),
                        num_bad=torch.zeros((), **i32), cooldown_count=torch.zeros((), **i32))


def plateau_step(state: PlateauState, metric: torch.Tensor, *, factor: float, patience: int,
                 threshold: float, cooldown: int, min_lr: float) -> PlateauState:
    """The next state after an update whose loss was ``metric`` (a new state;
    ``state`` is left as it was, so its lr can still serve the update)."""
    metric = metric.detach().float()
    zero = torch.zeros_like(state.num_bad)
    is_better = metric < state.best * (1.0 - threshold)
    best = torch.where(is_better, metric, state.best)

    in_cooldown = state.cooldown_count > 0
    num_bad = torch.where(is_better, zero, state.num_bad + 1)
    num_bad = torch.where(in_cooldown, zero, num_bad)
    cooldown_count = torch.where(in_cooldown, state.cooldown_count - 1, state.cooldown_count)

    reduce_now = num_bad > patience
    lr = torch.where(reduce_now, torch.clamp_min(state.lr * factor, min_lr), state.lr)
    cooldown_count = torch.where(reduce_now, torch.full_like(cooldown_count, cooldown),
                                 cooldown_count)
    num_bad = torch.where(reduce_now, zero, num_bad)
    return PlateauState(lr=lr, best=best, num_bad=num_bad, cooldown_count=cooldown_count)
