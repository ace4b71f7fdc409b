"""Exponential moving average of the trainable parameters
(port of ``bbdm_tpu/training/ema.py``).

    with decay: shadow <- (1 - decay) * p + decay * shadow   (fp32)
    warm-up   : shadow <- p                                    (before start_ema_step)

The JAX package also carries the frozen VQGAN through the average; it never
changes there, so here only the trainable parameters have a shadow and a
checkpoint's ``ema`` tree takes the VQGAN from the model.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def ema_init(params: dict) -> dict:
    """{name: fp32 copy} of ``params``."""
    return {k: p.detach().float().clone(memory_format=torch.contiguous_format)
            for k, p in params.items()}


@torch.no_grad()
def ema_update(ema: dict, params: dict, decay: float, with_decay: bool) -> None:
    """One EMA step in place; the warm-up copy where ``with_decay`` is False.
    (1 - decay) is taken in fp32, as the JAX update takes it."""
    shadow = list(ema.values())
    live = [params[k].detach().float() for k in ema]
    if not with_decay:
        torch._foreach_copy_(shadow, live)
        return
    d = np.float32(decay)
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, torch._foreach_mul(live, float(np.float32(1.0) - d)))


@contextlib.contextmanager
def swapped_in(params: dict, weights: dict):
    """Hold ``weights`` ({name: tensor} for some of ``params``) in the
    parameters for the length of the block, by swapping their storage (no
    copy); the parameters' own values and gradients come back after it."""
    names = [k for k in weights if k in params]
    for k in names:
        params[k].data, weights[k] = weights[k], params[k].data
    try:
        yield
    finally:
        for k in names:
            params[k].data, weights[k] = weights[k], params[k].data
