"""Seeded weights for both sides: one normal draw on the device for every
parameter at once, then each parameter's slice scaled by its kind.

The scales keep activations near unit size through every layer, so that the
sampler's 200 steps, the quantizer and the decoder all see signal: convs and
dense layers 1/sqrt(fan_in), GroupNorm scales 1 +- 0.1 and shifts +- 0.1 (so a
dropped affine shows), biases 0.02, and a codebook at the latents' own scale
(a codebook of tiny codes would make the decoder's input all but constant)."""

from __future__ import annotations

import math

import torch

CODEBOOK_STD = 0.5


def _std_mean(shape, kind):
    if kind in ("conv", "dense"):
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    return {"bias": (0.02, 0.0), "norm_w": (0.1, 1.0), "norm_b": (0.1, 0.0),
            "codebook": (CODEBOOK_STD, 0.0)}[kind]


def make_weights(specs: dict, seed: int, device) -> dict:
    """{name: float32 tensor} for ``specs`` ({name: (shape, kind)}), the same
    for the same seed on the same device; the tensors are views of one buffer."""
    total = sum(math.prod(shape) for shape, _ in specs.values())
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, (shape, kind) in specs.items():
        n = math.prod(shape)
        std, mean = _std_mean(shape, kind)
        out[name] = flat[off:off + n].mul_(std).add_(mean).view(shape)
        off += n
    return out
