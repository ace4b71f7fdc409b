"""GroupNorm with fp32 statistics over NCHW (or N, C, ...).

Behaviour of ``bbdm_tpu/ops/group_norm.py:_group_norm_xla``: statistics and
normalisation in float32, the affine folded into one scale and shift per
(n, c), optional FiLM ``y * (1 + s) + b`` per (n, c), optional SiLU, output in
the input dtype.

On a CUDA tensor every call goes to the Triton kernel
(``kernels/group_norm_triton.py``, which replaces the Pallas
``bbdm_tpu/ops/group_norm_pallas.py:group_norm_pallas``); on a CPU tensor to
:func:`group_norm_plain`.
"""

from __future__ import annotations

import math

import torch

from bbdm_tpu_torch.ops import use_kernel


def group_norm(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
               act: str | None = None, film_scale=None, film_shift=None):
    """GN(x) * weight + bias [* (1 + film_scale) + film_shift] [-> silu].

    x: [N, C, ...]; weight, bias: [C]; film_*: [N, C] or None (both or neither).
    """
    if act not in (None, "silu"):
        raise NotImplementedError(act)
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift go together")
    fn = group_norm_cuda if use_kernel(x) else group_norm_plain
    return fn(x, weight, bias, num_groups=num_groups, eps=eps, act=act,
              film_scale=film_scale, film_shift=film_shift)


def group_norm_plain(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                     act: str | None = None, film_scale=None, film_shift=None):
    """Plain PyTorch twin of ``_group_norm_xla``, in the same operation order."""
    N, C = x.shape[:2]
    if C % num_groups != 0:
        raise ValueError(f"channels {C} not divisible by num_groups {num_groups}")
    spatial = x.shape[2:]
    red = tuple(range(2, x.ndim))
    xf = x.float()
    n_per_group = (C // num_groups) * math.prod(spatial)
    s1 = xf.sum(red)  # [N, C]
    s2 = (xf * xf).sum(red)
    gs1 = s1.reshape(N, num_groups, C // num_groups).sum(-1)  # [N, G]
    gs2 = s2.reshape(N, num_groups, C // num_groups).sum(-1)
    mean_g = gs1 / n_per_group
    var_g = gs2 / n_per_group - mean_g * mean_g
    rstd_g = torch.rsqrt(var_g + eps)
    rstd_c = rstd_g.repeat_interleave(C // num_groups, dim=1)
    mean_c = mean_g.repeat_interleave(C // num_groups, dim=1)
    w = rstd_c * weight.float()[None, :]
    b = bias.float()[None, :] - mean_c * w
    shape = (N, C) + (1,) * len(spatial)
    y = xf * w.reshape(shape) + b.reshape(shape)
    if film_scale is not None:
        y = y * (1.0 + film_scale.float().reshape(shape))
        y = y + film_shift.float().reshape(shape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_cuda(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                    act: str | None = None, film_scale=None, film_shift=None):
    """Launch the Triton GroupNorm kernel; raises on what it does not take."""
    from bbdm_tpu_torch.kernels import group_norm_triton

    if not x.is_cuda:
        raise ValueError("group_norm_cuda takes a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"group_norm_cuda: unsupported dtype {x.dtype}")
    if x.ndim < 3 or not x.is_contiguous():
        raise ValueError("group_norm_cuda takes a contiguous [N, C, ...] tensor")
    N, C = x.shape[:2]
    if C % num_groups != 0:
        raise ValueError(f"channels {C} not divisible by num_groups {num_groups}")
    for p in (weight, bias):
        if p.shape != (C,) or p.dtype != torch.float32 or not p.is_contiguous() \
                or p.device != x.device:
            raise ValueError("group_norm_cuda takes contiguous fp32 [C] weight and bias")
    if film_scale is not None:
        for f in (film_scale, film_shift):
            if f.shape != (N, C) or f.stride(1) != 1 or f.device != x.device:
                raise ValueError("group_norm_cuda takes [N, C] film tensors with unit "
                                 "channel stride")
        if film_scale.stride(0) != film_shift.stride(0):
            raise ValueError("film_scale and film_shift need the same row stride")
    out = torch.empty_like(x)
    group_norm_triton.launch(x, weight, bias, film_scale, film_shift, out,
                             num_groups=num_groups, eps=eps, silu=act == "silu")
    group_norm_cuda.launches += 1
    return out


group_norm_cuda.launches = 0
