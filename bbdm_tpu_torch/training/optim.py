"""The optimizers of ``bbdm_tpu/training/optim.py`` with optax's arithmetic.

A unit-learning-rate transform: :meth:`Optimizer.update` takes the summed
gradients and the learning rate as a 0-d tensor on the device (the plateau
state's, so no host sync per update) and applies ``p += -lr * u``, as the JAX
step applies ``-lr * tx.update(...)`` with ``optax.apply_updates``. Only the
trainable parameters it is given are updated and hold state (the JAX
``optax.masked`` leaves the frozen VQGAN without moments).

* Adam: L2 weight decay added to the gradient before the moments
  (``add_decayed_weights`` ahead of ``scale_by_adam``), b2 0.999 (the
  ``b2`` argument: the VQGAN runner gives its players 0.9), eps 1e-8
  outside the sqrt, bias-corrected moments: u = mu_hat / (sqrt(nu_hat) + eps);
* RMSProp: optional L2 weight decay, then ``scale_by_rms(decay=0.99, eps=1e-8,
  eps_in_sqrt=False)``: u = g / (sqrt(nu) + eps), no bias correction;
* SGD: ``optax.trace(0.9)``: trace = g + 0.9 trace, u = trace (no weight
  decay, as the JAX package builds it).

No ``torch.optim`` class is used: they take the learning rate as a host number
(one device-to-host read of the plateau state per update) and round in
another order (``torch.optim.Adam`` divides by sqrt(v) / sqrt(bc2), RMSprop
keeps no state for the first step's square and SGD copies the first
gradient), so each update here repeats optax's operations in its order, in
fp32, with ``torch._foreach_*`` over all parameters at once.
"""

from __future__ import annotations

import numpy as np
import torch

_INT32_MAX = 2 ** 31 - 1


def _f32(v: float) -> float:
    """v rounded to fp32: the value a weakly typed Python scalar takes in a JAX fp32 op."""
    return float(np.float32(v))


class Optimizer:
    """Adam, RMSProp or SGD over ``params`` ({name: parameter}, the trainable
    ones, in a fixed order) from the ``model.BB.optimizer`` config node."""

    def __init__(self, optim_config, params: dict, *, b2: float = 0.999):
        self.name = optim_config.optimizer
        self.names = list(params)
        self.params = list(params.values())
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for p in self.params]
        device = self.params[0].device if self.params else None
        if self.name == "Adam":
            self.weight_decay = optim_config.get("weight_decay", 0.0)
            self.b1, self.b2 = optim_config.get("beta1", 0.9), b2
            self.eps = 1e-8
            self.state = {"count": torch.zeros((), dtype=torch.int32, device=device),
                          "mu": zeros(), "nu": zeros()}
        elif self.name == "RMSProp":
            self.weight_decay = optim_config.get("weight_decay", 0.0)
            self.decay, self.eps = 0.99, 1e-8
            self.state = {"nu": zeros()}
        elif self.name == "SGD":
            self.weight_decay = 0.0
            self.state = {"trace": zeros()}
        else:
            raise NotImplementedError(f"Optimizer {self.name} not understood.")

    @torch.no_grad()
    def update(self, grads: list, lr: torch.Tensor) -> None:
        """One update of every parameter from ``grads`` (one per parameter, in order)."""
        params, s = self.params, self.state
        if self.weight_decay:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, _f32(self.weight_decay)))
        if self.name == "Adam":
            torch._foreach_mul_(s["mu"], _f32(self.b1))
            torch._foreach_add_(s["mu"], torch._foreach_mul(grads, _f32(1 - self.b1)))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, _f32(1 - self.b2))
            torch._foreach_mul_(s["nu"], _f32(self.b2))
            torch._foreach_add_(s["nu"], sq)
            s["count"] = torch.where(s["count"] < _INT32_MAX, s["count"] + 1, s["count"])
            count = s["count"].float()
            bc1 = 1 - torch.pow(torch.tensor(_f32(self.b1), device=count.device), count)
            bc2 = 1 - torch.pow(torch.tensor(_f32(self.b2), device=count.device), count)
            den = torch._foreach_sqrt(torch._foreach_div(s["nu"], bc2))
            torch._foreach_add_(den, _f32(self.eps))
            updates = torch._foreach_div(torch._foreach_div(s["mu"], bc1), den)
        elif self.name == "RMSProp":
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, _f32(1 - self.decay))
            torch._foreach_mul_(s["nu"], _f32(self.decay))
            torch._foreach_add_(s["nu"], sq)
            scale = torch._foreach_sqrt(s["nu"])
            torch._foreach_add_(scale, _f32(self.eps))
            torch._foreach_reciprocal_(scale)
            updates = torch._foreach_mul(scale, grads)
        else:
            torch._foreach_mul_(s["trace"], _f32(0.9))
            torch._foreach_add_(s["trace"], grads)
            updates = s["trace"]
        torch._foreach_add_(params, torch._foreach_mul(updates, -lr))
