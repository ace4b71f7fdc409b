"""Multi-head attention with fp32 softmax over [B, H, T, D]
(twin of ``bbdm_tpu/ops/attention.py``).

q and k are each scaled by D^-1/4 (the reference's symmetric scaling) and the
softmax runs in float32. Dispatch mirrors ``bbdm_tpu/ops/attention.py:43-48``:
a CUDA tensor with T >= 1024 and D % 128 == 0 goes to kernel K3
(``csrc/flash_attention.cu`` for bf16, ``csrc/flash_attention_f32.cu`` for
fp32 in 3xTF32; both replace the Pallas
``bbdm_tpu/ops/flash_attention.py:flash_attention``); everything else, the
UNet's middle attention (T=256, 16 heads x 64) included, is the explicit
matmul + softmax of :func:`attention_plain`, as the JAX package leaves it to XLA.
Where grad mode is on and q, k or v requires grad, K3 launches through
:class:`FlashAttentionFunction`, whose backward recomputes the twin.
"""

from __future__ import annotations

import torch

from bbdm_tpu_torch.ops import needs_grad, recompute_grads, use_kernel

KERNEL_MIN_SEQ = 1024  # bbdm_tpu/ops/attention.py:_PALLAS_MIN_SEQ


def multi_head_attention(q, k, v):
    """q, k, v: [B, H, T, D] -> [B, H, T, D] in q.dtype."""
    if use_kernel(q) and q.shape[-2] >= KERNEL_MIN_SEQ and q.shape[-1] % 128 == 0:
        if needs_grad(q, k, v):
            return FlashAttentionFunction.apply(q, k, v)
        return flash_attention_cuda(q, k, v)
    return attention_plain(q, k, v)


class FlashAttentionFunction(torch.autograd.Function):
    """K3 with a gradient (``bbdm_tpu/ops/flash_attention.py:114-139``): the
    forward is one launch of :func:`flash_attention_cuda`; the backward
    recomputes :func:`attention_plain` on the saved q, k, v, as the Pallas
    kernel's ``custom_vjp`` recomputes ``_xla_attention``."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention_cuda(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(attention_plain, ctx.saved_tensors, ctx.needs_input_grad,
                               grad_out)


def attention_plain(q, k, v):
    """Twin of ``_xla_attention``: the scaled q, k round to the input dtype,
    both products accumulate in fp32, the softmax weights round to the input
    dtype before the second product."""
    scale = 1.0 / (q.shape[-1] ** 0.25)
    logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def flash_padded_dim(D):
    """K3's compiled head dim for a (memory) head dim D: 128, 256 or 512; TMA
    zero-fills the columns past D."""
    return 128 if D <= 128 else 256 if D <= 256 else 512


def flash_smem_bytes(D):
    """K3's dynamic shared memory at head dim D (csrc/flash_attention.cu
    smem_bytes): Q (64 rows x DP bf16), two stages each of K and V tiles
    (32 keys x DP bf16), the 2 x [64 x 32] fp32 score exchange, 9 mbarriers and
    1 KB of alignment slack."""
    dp = flash_padded_dim(D)
    return 64 * dp * 2 + 2 * 2 * 32 * dp * 2 + 2 * 64 * 32 * 4 + 9 * 8 + 1024


def flash_attention_cuda(q, k, v):
    """Launch K3 on contiguous [B, H, T, D] CUDA tensors of one dtype: bf16 with
    D % 16 == 0 (``csrc/flash_attention.cu``) or fp32 with D % 4 == 0
    (``csrc/flash_attention_f32.cu``), D <= 512. Output in q's dtype."""
    for t in (q, k, v):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32) or t.ndim != 4 \
                or not t.is_contiguous():
            raise ValueError("flash_attention_cuda takes contiguous bf16 or fp32 CUDA "
                             "[B, H, T, D]")
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention_cuda: q, k, v differ in shape, device or dtype")
    if q.dtype == torch.float32:
        return _flash_f32(q, k, v)
    return _flash_bf16(q, k, v)


def _flash_bf16(q, k, v):
    """A TMA box is 64 rows x 64 columns and must fit inside its tensor, so T or
    D below 64 is zero-padded to 64 (padded keys are masked, padded rows and
    columns not written) and the output cut back."""
    from bbdm_tpu_torch.kernels import build

    B, H, T, D = q.shape
    if D % 16 != 0 or D > 512:
        raise ValueError(f"flash_attention_cuda (bf16) takes D % 16 == 0 and D <= 512, got {D}")
    Tm, Dm = max(T, 64), max(D, 64)
    if (Tm, Dm) != (T, D):
        q, k, v = (torch.nn.functional.pad(t, (0, Dm - D, 0, Tm - T)) for t in (q, k, v))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = build.library().flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, T, D, Tm, Dm,
        flash_smem_bytes(Dm), stream)
    build.check("flash_attention_bf16", rc)
    flash_attention_cuda.launches += 1
    return out[..., :T, :D].contiguous() if (Tm, Dm) != (T, D) else out


def flash_f32_smem_bytes(D):
    """The fp32 K3's dynamic shared memory at head dim D
    (csrc/flash_attention_f32.cu smem_bytes): Q (64 rows x DP fp32), a 3-slot
    ring of 16-key K or V tiles (16 x DP fp32, at least the 16 KB of score
    partials each slot also holds), 7 mbarriers and 1 KB of alignment slack."""
    dp = flash_padded_dim(D)
    return 64 * dp * 4 + 3 * max(16 * dp * 4, 16384) + 7 * 8 + 1024


def _flash_f32(q, k, v):
    """The fp32 kernel masks keys and rows past T itself. Its pre-pass writes
    q and k times D^-1/4 into scratch allocated here, zero-padded to at least
    64 rows and 32 columns (one TMA box), and a padded copy of v only where
    that padding is needed."""
    from bbdm_tpu_torch.kernels import build

    B, H, T, D = q.shape
    if D % 4 != 0 or D > 512 or T == 0:
        raise ValueError(f"flash_attention_cuda (fp32) takes D % 4 == 0, D <= 512 and T > 0, "
                         f"got D={D}, T={T}")
    Tm, Dm = max(T, 64), max(D, 32)
    qs, ks = (q.new_empty((B * H, Tm, Dm)) for _ in range(2))
    vs = q.new_empty((B * H, Tm, Dm)) if (Tm, Dm) != (T, D) else None
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = build.library().flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        None if vs is None else vs.data_ptr(), B * H, T, D, Tm, Dm, flash_f32_smem_bytes(Dm),
        stream)
    build.check("flash_attention_f32", rc)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
