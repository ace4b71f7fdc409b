"""Fused nearest-2x upsample + 3x3 conv, NCHW (twin of ``bbdm_tpu/ops/upsample_conv.py``).

On a nearest-2x grid each 3x3 window covers at most 2x2 distinct source
pixels, so ``conv3x3(pad=1)(upsample_nearest_2x(x))`` is exactly four 2x2
"phase" convolutions whose kernels are fixed sums of the 3x3 taps
(:func:`combine_kernel_2x2`), interleaved into the 2x output.

On a CUDA tensor every call goes to kernel K2 (``csrc/subpixel_upconv.cu``,
which replaces the Pallas ``bbdm_tpu/ops/subpixel_pallas.py:subpixel_upconv_pallas``);
on a CPU tensor to :func:`upsample_conv_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bbdm_tpu_torch.ops import use_kernel


def combine_kernel_2x2(w: torch.Tensor) -> torch.Tensor:
    """[co, ci, 3, 3] OIHW -> [4, 2, 2, co, ci] phase kernel (fp32 combine, then
    cast back to w's dtype).

    Phase p = 2*py + px; tap (r, s) of phase p reads source offset
    (py - 1 + r, px - 1 + s). Along each axis: py=0 -> taps (W0, W1+W2),
    py=1 -> (W0+W1, W2).
    """
    wf = w.float()

    def pair(a, axis, phase):
        t0, t1, t2 = a.unbind(axis)
        return (t0, t1 + t2) if phase == 0 else (t0 + t1, t2)

    phases = []
    for py in (0, 1):
        rows = pair(wf, 2, py)  # each [co, ci, 3]
        for px in (0, 1):
            taps = [torch.stack(pair(r, 2, px), 0) for r in rows]  # each [2(s), co, ci]
            phases.append(torch.stack(taps, 0))  # [2(r), 2(s), co, ci]
    return torch.stack(phases, 0).to(w.dtype)


def upsample2x_conv3x3(x, w, b, *, dtype=None, combined=None):
    """Exactly ``conv3x3(pad=1)(upsample_nearest_2x(x)) + b``.

    x: [N, ci, H, W]; w: [co, ci, 3, 3]; b: [co]. ``dtype``: compute dtype
    (None: promote x and w). ``combined``: the [4, 2, 2, co, ci] phase kernel
    in the compute dtype, when the caller hoisted the combine out of a loop.
    Returns [N, co, 2H, 2W].
    """
    dt = dtype or torch.promote_types(x.dtype, w.dtype)
    if not use_kernel(x):
        return upsample_conv_plain(x, w, b, dtype=dt)
    k = combine_kernel_2x2(w) if combined is None else combined
    return upsample_conv_cuda(x.to(dt).contiguous(), k.to(dt), b.float())


def upsample_conv_plain(x, w, b, *, dtype=None):
    """Plain PyTorch twin: conv2d(interpolate(x, 2, 'nearest'), w, b, padding=1)."""
    dt = dtype or torch.promote_types(x.dtype, w.dtype)
    up = F.interpolate(x.to(dt), scale_factor=2, mode="nearest")
    return F.conv2d(up, w.to(dt), b.to(dt), padding=1)


def upsample_conv_cuda(x, kp, b):
    """Launch K2. x [N, ci, h, w] bf16; kp [4, 2, 2, co, ci] bf16; b [co] fp32."""
    from bbdm_tpu_torch.kernels import build

    if not x.is_cuda or x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("upsample_conv_cuda takes a contiguous bf16 CUDA [N, ci, h, w] tensor")
    N, ci, h, w = x.shape
    if ci % 32 != 0:
        raise ValueError(f"upsample_conv_cuda needs ci % 32 == 0, got {ci}")
    co = kp.shape[3]
    if kp.shape != (4, 2, 2, co, ci) or kp.dtype != torch.bfloat16 \
            or not kp.is_contiguous() or kp.device != x.device:
        raise ValueError(f"phase kernel must be contiguous bf16 [4, 2, 2, co, {ci}]")
    if b.shape != (co,) or b.dtype != torch.float32 or not b.is_contiguous() \
            or b.device != x.device:
        raise ValueError("bias must be contiguous fp32 [co]")
    out = torch.empty((N, co, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().subpixel_upconv_bf16(
        x.data_ptr(), kp.data_ptr(), b.data_ptr(), out.data_ptr(), N, ci, co, h, w, stream)
    build.check("subpixel_upconv_bf16", rc)
    upsample_conv_cuda.launches += 1
    return out


upsample_conv_cuda.launches = 0
