"""K1: fused GroupNorm (+FiLM +SiLU) forward in Triton, NCHW.

Replaces ``bbdm_tpu/ops/group_norm_pallas.py:group_norm_pallas`` (the Pallas
``_kernel``, two phases over (N, 2, tiles) carrying sums in VMEM scratch).

What bounds it on the H100: memory. It does ~10 flops per element against
2 bf16 reads and 1 write (6 bytes), far below the ~295 flops/byte where bf16
compute would bind. The largest call on LBBDM-f4 is the VQGAN decoder's
[8, 256, 256, 256] bf16 norm, 268 MB read twice and written once: ~0.24 ms at
3.35 TB/s.

Design: in NCHW one (n, group) slice is one contiguous span of C/G * HW
elements (up to 524,288 on the path). A TPU grid runs in order and can carry
sums across tiles; Hopper blocks run in parallel, so the span is cut into
CHUNK-element pieces and the work is two launches over (N*G, n_split):
``_stats`` writes each piece's fp32 sum and sum of squares, ``_apply`` reduces
the n_split partials of its (n, g) (a few hundred bytes, from L2), forms
mean and rstd, and streams normalise + affine + FiLM + SiLU for its piece.
Enough programs to fill 132 SMs at every path shape, coalesced contiguous
loads, and no atomics, so the result is deterministic. Unlike the Pallas
``eligible`` (C % 128 == 0, hw % 8 == 0) it takes any C divisible by G.

triton is imported, and the kernels defined, on first launch only.
"""

from __future__ import annotations

import functools

import torch

CHUNK = 4096  # elements of one (n, g) span per program
BLOCK = 1024  # elements per vector step inside a program


@functools.cache
def _kernels():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def _stats(x_ptr, part_ptr, span, n_split,
               CHUNK: tl.constexpr, BLOCK: tl.constexpr):
        ng = tl.program_id(0)
        sp = tl.program_id(1)
        base = ng.to(tl.int64) * span
        acc1 = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, CHUNK, BLOCK):
            idx = sp * CHUNK + off + tl.arange(0, BLOCK)
            v = tl.load(x_ptr + base + idx, mask=idx < span, other=0.0).to(tl.float32)
            acc1 += v
            acc2 += v * v
        out = part_ptr + (ng * n_split + sp) * 2
        tl.store(out, tl.sum(acc1, axis=0))
        tl.store(out + 1, tl.sum(acc2, axis=0))

    @triton.jit
    def _apply(x_ptr, out_ptr, part_ptr, w_ptr, b_ptr, fs_ptr, fb_ptr, film_stride,
               span, hw, cpg, groups, n_split, n_per_group, eps,
               CHUNK: tl.constexpr, BLOCK: tl.constexpr, SPLIT_P2: tl.constexpr,
               FILM: tl.constexpr, SILU: tl.constexpr):
        ng = tl.program_id(0)
        sp = tl.program_id(1)
        n = ng // groups
        g = ng % groups
        k = tl.arange(0, SPLIT_P2)
        pm = k < n_split
        s1 = tl.sum(tl.load(part_ptr + (ng * n_split + k) * 2, mask=pm, other=0.0), axis=0)
        s2 = tl.sum(tl.load(part_ptr + (ng * n_split + k) * 2 + 1, mask=pm, other=0.0), axis=0)
        mean = s1 / n_per_group
        var = s2 / n_per_group - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        base = ng.to(tl.int64) * span
        for off in range(0, CHUNK, BLOCK):
            idx = sp * CHUNK + off + tl.arange(0, BLOCK)
            m = idx < span
            c = g * cpg + idx // hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            wc = tl.load(w_ptr + c, mask=m, other=0.0) * rstd
            bc = tl.load(b_ptr + c, mask=m, other=0.0) - mean * wc
            y = v * wc + bc
            if FILM:
                fs = tl.load(fs_ptr + n * film_stride + c, mask=m, other=0.0).to(tl.float32)
                fb = tl.load(fb_ptr + n * film_stride + c, mask=m, other=0.0).to(tl.float32)
                y = y * (1.0 + fs) + fb
            if SILU:
                y = y * tl.sigmoid(y)
            tl.store(out_ptr + base + idx, y.to(out_ptr.dtype.element_ty), mask=m)

    return _stats, _apply


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           film_scale, film_shift, out: torch.Tensor, *, num_groups: int,
           eps: float, silu: bool) -> None:
    """Enqueue the two launches on the current stream (the caller checked the
    arguments: contiguous x/out, fp32 [C] weight/bias, [N, C] film)."""
    stats, apply = _kernels()
    N, C = x.shape[:2]
    hw = x.numel() // (N * C)
    cpg = C // num_groups
    span = cpg * hw
    n_split = -(-span // CHUNK)
    part = torch.empty((N * num_groups, n_split, 2), dtype=torch.float32, device=x.device)
    grid = (N * num_groups, n_split)
    stats[grid](x, part, span, n_split, CHUNK=CHUNK, BLOCK=BLOCK, num_warps=4)
    film = film_scale is not None
    fs, fb = (film_scale, film_shift) if film else (weight, bias)
    apply[grid](x, out, part, weight, bias, fs, fb,
                film_scale.stride(0) if film else 0,
                span, hw, cpg, num_groups, n_split, float(span), float(eps),
                CHUNK=CHUNK, BLOCK=BLOCK,
                SPLIT_P2=max(2, 1 << (n_split - 1).bit_length()),
                FILM=film, SILU=silu, num_warps=4)
