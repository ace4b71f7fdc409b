"""The control: the reference computed one precision below the bfloat16 that
the configurations state. Every conv, linear and attention operand (inputs,
weights, the softmax weights) is rounded to float8 e4m3 with one scale per
tensor (its largest magnitude at 448, e4m3's largest finite value); sums stay
float32. A comparison that cannot tell this from the reference is too loose."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.model import Ops

E4M3_MAX = 448.0


def fp8(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in float32;
    the gradient passes the rounding unchanged (as a bf16 program's gradient
    passes its casts at the gradient's own precision)."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (rounded - t).detach()


class Fp8Ops(Ops):
    def conv(self, x, w, b, stride=1, padding=0):
        return F.conv2d(fp8(x), fp8(w), b, stride=stride, padding=padding)

    def linear(self, x, w, b=None):
        return F.linear(fp8(x), fp8(w), b)

    def attention(self, q, k, v):
        logits = torch.matmul(fp8(q), fp8(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
        return torch.matmul(fp8(torch.softmax(logits, dim=-1)), fp8(v))
