"""Operators with a hand-written Hopper kernel and a plain PyTorch twin.

Each dispatch sends a CUDA tensor to the kernel and a CPU tensor to the twin;
the twin is never a fallback for a CUDA tensor. Where an input requires grad,
K1 and K3 launch through an autograd Function: K1's backward is a kernel of its
own (``csrc/group_norm_bwd.cu``), K3's recomputes the twin (the JAX package's
``custom_vjp``s recompute through XLA the same way); K2 has no backward and
refuses such inputs.
"""

import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense bf16 and TF32 tensor-core and
# fp32 rates; the kernels' bounds divide their bytes and operations by these
PEAK_BYTES_S, PEAK_BF16_FLOPS, PEAK_FP32_FLOPS = 3.35e12, 989e12, 67e12
PEAK_TF32_FLOPS = 495e12


# every count that a replayed CUDA graph adds to as its capture did, as
# (holder, attribute): each kernel wrapper's ``launches`` and the attention
# dispatch's calls and FLOPs per route (``ops/attention.py`` ``ROUTES``)
REPLAYED_COUNTS = []


def counts_launches(fn):
    """Register ``fn``, a kernel's launching wrapper that adds one to
    ``fn.launches`` per launch, in :data:`REPLAYED_COUNTS`."""
    fn.launches = 0
    REPLAYED_COUNTS.append((fn, "launches"))
    return fn


def read_counts() -> list:
    """The values of :data:`REPLAYED_COUNTS`, in its order."""
    return [getattr(holder, attr) for holder, attr in REPLAYED_COUNTS]


def write_counts(values, add=False) -> None:
    """Set :data:`REPLAYED_COUNTS` to ``values`` (:func:`read_counts`'s
    order), or add ``values`` to them."""
    for (holder, attr), v in zip(REPLAYED_COUNTS, values):
        setattr(holder, attr, getattr(holder, attr) + v if add else v)


def use_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises on any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel and no twin for device {x.device}")


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of ``tensors`` (None skipped) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def recompute_grads(plain, inputs, needed, grad_out, **kw):
    """The gradients of ``plain(*inputs, **kw)`` with respect to the ``inputs``
    flagged in ``needed`` (None elsewhere), recomputed from the saved inputs
    under grad mode: the backward of K3's autograd Function."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(inputs, needed)]
        out = plain(*leaves, **kw)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out) if wanted else ())
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: the low 13 bits of the result are zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): the split of the fp32 K2 and
    K3 kernels (``csrc/hopper.cuh:split_tf32``), whose 3xTF32 products are
    hi*hi + hi*lo + lo*hi."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)
