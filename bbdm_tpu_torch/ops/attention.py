"""Multi-head attention with fp32 softmax over [B, H, T, D]
(twin of ``bbdm_tpu/ops/attention.py``).

q and k are each scaled by D^-1/4 (the reference's symmetric scaling) and the
softmax runs in float32; k and v may hold another number of tokens (Tk) than q
(Tq), as in cross-attention. A CUDA tensor goes to kernel K3
(``csrc/flash_attention.cu`` for bf16, ``csrc/flash_attention_f32.cu`` for
fp32 in 3xTF32; both replace the Pallas
``bbdm_tpu/ops/flash_attention.py:flash_attention``) where :func:`flash_route`
says so: the JAX package's rule (``bbdm_tpu/ops/attention.py:43-48``, Tq >=
1024 and D % 128 == 0), and in bf16 also any head dim D % 8 == 0 up to 256
once Tq * Tk >= 2^20 (the cross-attention UNet's heads of 40, 80 and 160; a
departure from the JAX package, which leaves those to XLA). Everything else,
the templates' UNet middle attention (T=256, 16 heads x 64) included, is the
explicit matmul + softmax of :func:`attention_plain`. The CPU always runs
the twin. Where grad mode is on and q, k or v requires grad, K3 launches
through :class:`FlashAttentionFunction`, whose backward recomputes the twin.

:data:`ROUTES` counts the calls and the QK^T + PV FLOPs each route served
(``kernel``: K3, ``plain``: the twin); a replayed CUDA graph adds to them as
its capture did (``ops.REPLAYED_COUNTS``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bbdm_tpu_torch.ops import (
    REPLAYED_COUNTS,
    counts_launches,
    needs_grad,
    recompute_grads,
    use_kernel,
)

KERNEL_MIN_SEQ = 1024  # bbdm_tpu/ops/attention.py:_PALLAS_MIN_SEQ
KERNEL_MIN_SCORES = 1 << 20  # Tq * Tk from which bf16 heads of 8..256 go to K3


def flash_route(Tq, Tk, D, dtype) -> bool:
    """Whether the CUDA dispatch sends attention of Tq queries, Tk keys and
    head dim D in ``dtype`` to K3: Tq >= :data:`KERNEL_MIN_SEQ` and D % 128 ==
    0 (the JAX package's rule), or in bf16 Tq * Tk >= :data:`KERNEL_MIN_SCORES`
    and D % 8 == 0, D <= 256, where the twin's [Tq, Tk] fp32 logits would
    take at least 4 MB a head."""
    if Tq >= KERNEL_MIN_SEQ and D % 128 == 0:
        return True
    return dtype == torch.bfloat16 and Tq * Tk >= KERNEL_MIN_SCORES and D % 8 == 0 and D <= 256


class RouteTally:
    """One route's calls and QK^T + PV FLOPs (4 B H Tq Tk D a call)."""

    __slots__ = ("calls", "flops")

    def __init__(self):
        self.calls = self.flops = 0


ROUTES = {"kernel": RouteTally(), "plain": RouteTally()}
REPLAYED_COUNTS.extend((t, a) for t in ROUTES.values() for a in RouteTally.__slots__)


def multi_head_attention(q, k, v):
    """q: [B, H, Tq, D], k, v: [B, H, Tk, D] -> [B, H, Tq, D] in q.dtype, by
    the route :func:`flash_route` gives a CUDA tensor."""
    B, H, Tq, D = q.shape
    Tk = k.shape[-2]
    kernel = use_kernel(q) and flash_route(Tq, Tk, D, q.dtype)
    tally = ROUTES["kernel" if kernel else "plain"]
    tally.calls += 1
    tally.flops += 4 * B * H * Tq * Tk * D
    if kernel:
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


def flash_padded_dim(D, dtype=torch.float32):
    """K3's compiled head dim for a (memory) head dim D: 128, 256 or 512, and
    in bf16 also 64; TMA zero-fills the columns past D."""
    if dtype == torch.bfloat16 and D <= 64:
        return 64
    return 128 if D <= 128 else 256 if D <= 256 else 512


def flash_smem_bytes(D):
    """The bf16 K3's dynamic shared memory at head dim D
    (csrc/flash_attention.cu smem_bytes). Up to DP = 128 (the row split): Q
    of 128 rows x DP bf16 and 4 stages each of K and V tiles (32 keys x DP
    bf16); at DP = 256 and 512 (the depth split): Q of 64 rows, 2 stages and
    the 2 x [64 x 32] fp32 score exchange; then 1 + 4 x stages mbarriers and 1
    KB of alignment slack. The key loop streams its tiles through the stages,
    so no length, Tq or Tk, enters it."""
    dp = flash_padded_dim(D, torch.bfloat16)
    rows = 2 if dp <= 128 else 1
    stages = 4 if dp <= 128 else 2
    exchange = 0 if rows == 2 else 2 * 64 * 32 * 4
    return rows * 64 * dp * 2 + 2 * stages * 32 * dp * 2 + exchange + (1 + 4 * stages) * 8 + 1024


def flash_f32_smem_bytes(D):
    """The fp32 K3's dynamic shared memory at head dim D
    (csrc/flash_attention_f32.cu smem_bytes): Q (64 rows x DP fp32), a 3-slot
    ring of 16-key K or V tiles (16 x DP fp32, at least the 16 KB of score
    partials each slot also holds), 7 mbarriers and 1 KB of alignment slack;
    like the bf16 kernel's, independent of Tq and Tk."""
    dp = flash_padded_dim(D)
    return 64 * dp * 4 + 3 * max(16 * dp * 4, 16384) + 7 * 8 + 1024


class FlashPlan(NamedTuple):
    """K3's padded extents for q [B, H, Tq, D] and k, v [B, H, Tk, D]: rows of
    q (``Tqm``) and of k and v (``Tkm``) and columns (``Dm``) in device memory,
    each at least one TMA box (64 rows; 64 bf16 or 32 fp32 columns), so that
    every box fits inside its tensor; the compiled head dim ``DP`` and the
    dynamic shared memory ``smem``. Keys past Tk are masked by count in the
    kernel, never summed as zeros; query rows past Tq are not written."""
    Tqm: int
    Tkm: int
    Dm: int
    DP: int
    smem: int


def plan_flash(Tq, Tk, D, dtype) -> FlashPlan:
    """K3's plan (:class:`FlashPlan`) for bf16 or fp32. Raises ValueError on a
    shape the kernel does not take, saying which: D <= 512 (the Pallas kernel
    has no such limit), D % 8 == 0 in bf16 and D % 4 == 0 in fp32 (16-byte TMA
    rows), and Tq, Tk >= 1."""
    f32 = dtype == torch.float32
    if Tq < 1 or Tk < 1 or D < 1:
        raise ValueError(f"flash_attention_cuda takes Tq, Tk, D >= 1, got Tq={Tq}, Tk={Tk}, "
                         f"D={D}")
    if D > 512 or D % (4 if f32 else 8) != 0:
        raise ValueError(f"flash_attention_cuda ({'fp32' if f32 else 'bf16'}) takes "
                         f"D % {4 if f32 else 8} == 0 and D <= 512, got D={D}")
    Dm = max(D, 32 if f32 else 64)
    return FlashPlan(max(Tq, 64), max(Tk, 64), Dm, flash_padded_dim(Dm, dtype),
                     flash_f32_smem_bytes(Dm) if f32 else flash_smem_bytes(Dm))


@counts_launches
def flash_attention_cuda(q, k, v):
    """Launch K3 on contiguous CUDA tensors of one dtype, q [B, H, Tq, D] and
    k, v [B, H, Tk, D] (Tk may differ from Tq, as in the Pallas kernel): bf16
    (``csrc/flash_attention.cu``) or fp32 (``csrc/flash_attention_f32.cu``);
    :func:`plan_flash` says which D. Output [B, H, Tq, D] in q's dtype."""
    for t in (q, k, v):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32) or t.ndim != 4 \
                or not t.is_contiguous():
            raise ValueError("flash_attention_cuda takes contiguous bf16 or fp32 CUDA "
                             "[B, H, T, D]")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention_cuda: q, k, v differ in device or dtype")
    B, H, Tq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"flash_attention_cuda takes q [B, H, Tq, D] and k, v [B, H, Tk, D], "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    plan = plan_flash(Tq, k.shape[2], D, q.dtype)
    if q.dtype == torch.float32:
        return _flash_f32(q, k, v, plan)
    return _flash_bf16(q, k, v, plan)


def _flash_bf16(q, k, v, plan):
    """A TMA box is 64 rows x 64 columns and must fit inside its tensor, so q
    (Tq rows), k and v (Tk rows) below 64 rows, or D below 64, are zero-padded
    as :func:`plan_flash` says and the output cut back."""
    from bbdm_tpu_torch.kernels import build

    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    pad = lambda t, T, Tm: (t if (Tm, plan.Dm) == (T, D)
                            else torch.nn.functional.pad(t, (0, plan.Dm - D, 0, Tm - T)))
    q = pad(q, Tq, plan.Tqm)
    k, v = pad(k, Tk, plan.Tkm), pad(v, Tk, plan.Tkm)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = build.library().flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, Tq, Tk, D, plan.Tqm,
        plan.Tkm, plan.Dm, plan.smem, stream)
    build.check("flash_attention_bf16", rc)
    flash_attention_cuda.launches += 1
    return out[..., :Tq, :D].contiguous() if (plan.Tqm, plan.Dm) != (Tq, D) else out


def _flash_f32(q, k, v, plan):
    """The fp32 kernel masks keys past Tk and rows past Tq itself. Its pre-pass
    writes q and k times D^-1/4 into scratch allocated here, zero-padded as
    :func:`plan_flash` says, and a padded copy of v only where that padding is
    needed."""
    from bbdm_tpu_torch.kernels import build

    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    qs = q.new_empty((B * H, plan.Tqm, plan.Dm))
    ks = q.new_empty((B * H, plan.Tkm, plan.Dm))
    vs = q.new_empty((B * H, plan.Tkm, plan.Dm)) if (plan.Tkm, plan.Dm) != (Tk, D) else None
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = build.library().flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        None if vs is None else vs.data_ptr(), B * H, Tq, Tk, D, plan.Tqm, plan.Tkm, plan.Dm,
        plan.smem, stream)
    build.check("flash_attention_f32", rc)
    flash_attention_cuda.launches += 1
    return out
