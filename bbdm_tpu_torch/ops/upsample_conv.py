"""Fused nearest-2x upsample + 3x3 conv, NCHW (twin of ``bbdm_tpu/ops/upsample_conv.py``).

On a nearest-2x grid each 3x3 window covers at most 2x2 distinct source
pixels, so ``conv3x3(pad=1)(upsample_nearest_2x(x))`` is exactly four 2x2
"phase" convolutions whose kernels are fixed sums of the 3x3 taps
(:func:`combine_kernel_2x2`), interleaved into the 2x output.

On a CUDA tensor every call goes to kernel K2 (``csrc/subpixel_upconv.cu`` for
bf16, ``csrc/subpixel_upconv_f32.cu`` for fp32 in 3xTF32; both replace the
Pallas ``bbdm_tpu/ops/subpixel_pallas.py:subpixel_upconv_pallas``); on a CPU
tensor to :func:`upsample_conv_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from bbdm_tpu_torch.ops import counts_launches, needs_grad, use_kernel


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


# K2's block tile (csrc/subpixel_upconv{,_f32}.cu): BM output channels x BN source
# pixels, BK bf16 input channels per pipeline stage (one 128-byte swizzle row;
# 32 channels in fp32)
BM, BN, BK = 128, 128, 64


class UpconvPlan(NamedTuple):
    """K2's tiles and TMA boxes for x [N, ci, h, w].

    A block owns BN source pixels of one sample (``rows`` image rows of a
    ``w_box``-wide segment) for BM output channels and one py (both px). The
    kernel reads a channels-last copy of x, zero-padded to ``x_dims`` where a
    box would not fit inside the tensor. Dims, strides (bytes, of dims 1..) and
    boxes are innermost first; the C entry encodes and launches exactly these
    values (:meth:`c_values`) and refuses boxes it was not compiled for. Both
    maps use the 128-byte swizzle.
    """
    w_box: int
    rows: int
    row_tiles: int
    segs: int
    grid: tuple
    x_dims: tuple  # (ci, w, h, N), padded
    x_strides: tuple
    x_box: tuple
    k_dims: tuple  # (ci, co, 16), padded
    k_strides: tuple
    k_box: tuple
    swizzle: int = 128

    def c_values(self) -> tuple:
        """The 24 values ``subpixel_upconv_bf16`` takes, in its order."""
        return (*self.x_dims, *self.x_strides, *self.x_box, *self.k_dims, *self.k_strides,
                *self.k_box, *self.grid, self.row_tiles, self.segs)


@functools.lru_cache(maxsize=None)
def plan_upconv(N, ci, co, h, w, esize=2) -> UpconvPlan:
    """The widest power-of-two row segment (8 ... 128 pixels) that ``w`` fills;
    rows of it make up the BN pixels of a block. For elements of ``esize``
    bytes (2: bf16, 4: fp32), a stage takes bk = 128 / esize input channels;
    ci is padded to a multiple of 16 bytes and at least bk, co to at least BM, h
    to at least one tile of rows and w to 8."""
    bk, align = BK * 2 // esize, 16 // esize
    wp = max(w, 8)
    w_box = min(128, 1 << (wp.bit_length() - 1))
    rows = BN // w_box
    hp, cip, cop = max(h, rows), max(bk, -(-ci // align) * align), max(BM, co)
    row_tiles, segs = -(-hp // rows), -(-wp // w_box)
    return UpconvPlan(
        w_box=w_box, rows=rows, row_tiles=row_tiles, segs=segs,
        grid=(N * row_tiles * segs, -(-cop // BM), 2),
        x_dims=(cip, wp, hp, N),
        x_strides=(esize * cip, esize * wp * cip, esize * hp * wp * cip),
        x_box=(bk, w_box, rows, 1),
        k_dims=(cip, cop, 16), k_strides=(esize * cip, esize * cop * cip), k_box=(bk, BM, 1))


@functools.lru_cache(maxsize=None)
def _c_plan(plan: UpconvPlan):
    values = plan.c_values()
    return (ctypes.c_uint64 * len(values))(*values)


@counts_launches
def upsample_conv_cuda(x, kp, b):
    """Launch K2. x [N, ci, h, w] bf16 or fp32; kp [4, 2, 2, co, ci] in x's dtype;
    b [co] fp32. Output in x's dtype.

    K2 has no backward (the Pallas kernel has no VJP either): it raises where
    grad mode is on and an input requires grad, so it never cuts a graph."""
    if needs_grad(x, kp, b):
        raise RuntimeError("upsample_conv_cuda (K2) has no backward and refuses inputs that "
                           "require grad; train with UpsampleConv3x3 in training mode (the "
                           "naive upsample + conv)")
    if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 4 \
            or not x.is_contiguous():
        raise ValueError("upsample_conv_cuda takes a contiguous bf16 or fp32 CUDA "
                         "[N, ci, h, w] tensor")
    N, ci, h, w = x.shape
    co = kp.shape[3]
    if kp.shape != (4, 2, 2, co, ci) or kp.dtype != x.dtype \
            or not kp.is_contiguous() or kp.device != x.device:
        raise ValueError(f"phase kernel must be contiguous {x.dtype} [4, 2, 2, co, {ci}]")
    if b.shape != (co,) or b.dtype != torch.float32 or not b.is_contiguous() \
            or b.device != x.device:
        raise ValueError("bias must be contiguous fp32 [co]")
    if x.dtype == torch.float32:
        return _upconv_f32(x, kp, b)
    return _upconv_bf16(x, kp, b)


def _upconv_f32(x, kp, b):
    """``csrc/subpixel_upconv_f32.cu``: NCHW in and out. Its pre-passes write
    the split halves of x (channels-last, zero-padded as :func:`plan_upconv`
    says) and of the phase kernel into scratch allocated here, in the same
    call; the kernel parks its px = 0 results in a third."""
    from bbdm_tpu_torch.kernels import build

    N, ci, h, w = x.shape
    co = kp.shape[3]
    plan = plan_upconv(N, ci, co, h, w, esize=4)
    (cip, wp, hp, _), cop = plan.x_dims, plan.k_dims[1]
    x_hi, x_lo = (x.new_empty((N, hp, wp, cip)) for _ in range(2))
    k_hi, k_lo = (x.new_empty((16, cop, cip)) for _ in range(2))
    half0 = x.new_empty((2, N, co, h, w))  # the px = 0 results of each py until px = 1
    out = torch.empty((N, co, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().subpixel_upconv_f32(
        x.data_ptr(), kp.data_ptr(), b.data_ptr(), out.data_ptr(), x_hi.data_ptr(),
        x_lo.data_ptr(), k_hi.data_ptr(), k_lo.data_ptr(), half0.data_ptr(), N, ci, co, h, w,
        _c_plan(plan), stream)
    build.check("subpixel_upconv_f32", rc)
    upsample_conv_cuda.launches += 1
    return out


def _upconv_bf16(x, kp, b):
    """``csrc/subpixel_upconv.cu`` reads x channels-last, so x is copied once into
    that layout, zero-padded where :func:`plan_upconv` says (the padding is the
    conv's own; the extra outputs are cut off)."""
    from bbdm_tpu_torch.kernels import build

    N, ci, h, w = x.shape
    co = kp.shape[3]
    plan = plan_upconv(N, ci, co, h, w)
    (cip, wp, hp, _), cop = plan.x_dims, plan.k_dims[1]
    padded = (cip, wp, hp, cop) != (ci, w, h, co)
    if padded:
        xl = x.new_zeros((N, hp, wp, cip))
        xl[:, :h, :w, :ci] = x.permute(0, 2, 3, 1)
        kpp = kp.new_zeros((4, 2, 2, cop, cip))
        kpp[..., :co, :ci] = kp
        bp = b.new_zeros(cop)
        bp[:co] = b
    else:
        xl, kpp, bp = x.permute(0, 2, 3, 1).contiguous(), kp, b
    out = torch.empty((N, cop, 2 * hp, 2 * wp), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().subpixel_upconv_bf16(
        xl.data_ptr(), kpp.data_ptr(), bp.data_ptr(), out.data_ptr(), _c_plan(plan), stream)
    build.check("subpixel_upconv_bf16", rc)
    upsample_conv_cuda.launches += 1
    return out[:, :co, :2 * h, :2 * w].contiguous() if padded else out
