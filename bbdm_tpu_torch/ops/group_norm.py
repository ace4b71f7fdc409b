"""GroupNorm with fp32 statistics over NCHW (or N, C, ...).

Behaviour of ``bbdm_tpu/ops/group_norm.py:_group_norm_xla``: statistics and
normalisation in float32, the affine folded into one scale and shift per
(n, c), optional FiLM ``y * (1 + s) + b`` per (n, c), optional SiLU, output in
the input dtype.

On a CUDA tensor every call is one launch of kernel K1 (``csrc/group_norm.cu``,
which replaces the Pallas ``bbdm_tpu/ops/group_norm_pallas.py:group_norm_pallas``)
with the launch shape of :func:`plan_group_norm`; on a CPU tensor it goes to
:func:`group_norm_plain`. Where grad mode is on and an input requires grad,
the launch goes through :class:`GroupNormFunction`, whose backward is one call
of its own kernel (``csrc/group_norm_bwd.cu``, :func:`group_norm_bwd_cuda`, with
the launch shape of :func:`plan_group_norm_bwd`); its plain version is
:func:`group_norm_backward_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from bbdm_tpu_torch.ops import counts_launches, needs_grad, use_kernel


def group_norm(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
               act: str | None = None, film_scale=None, film_shift=None):
    """GN(x) * weight + bias [* (1 + film_scale) + film_shift] [-> silu].

    x: [N, C, ...]; weight, bias: [C]; film_*: [N, C] or None (both or neither).
    """
    if act not in (None, "silu"):
        raise NotImplementedError(act)
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift go together")
    if not use_kernel(x):
        return group_norm_plain(x, weight, bias, num_groups=num_groups, eps=eps, act=act,
                                film_scale=film_scale, film_shift=film_shift)
    if needs_grad(x, weight, bias, film_scale, film_shift):
        return GroupNormFunction.apply(x, weight, bias, film_scale, film_shift, num_groups,
                                       eps, act)
    return group_norm_cuda(x, weight, bias, num_groups=num_groups, eps=eps, act=act,
                           film_scale=film_scale, film_shift=film_shift)


class GroupNormFunction(torch.autograd.Function):
    """K1 with a gradient (``bbdm_tpu/ops/group_norm_pallas.py:177-216``): the
    forward is one launch of :func:`group_norm_cuda`; the backward is one call
    of :func:`group_norm_bwd_cuda` on the saved inputs (not the output, as the
    Pallas ``_fwd`` saves them), which recomputes the statistics and returns the
    gradients for x, weight, bias and the FiLM scale and shift that autograd
    asks for."""

    @staticmethod
    def forward(ctx, x, weight, bias, film_scale, film_shift, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias, film_scale, film_shift)
        ctx.kw = dict(num_groups=num_groups, eps=eps, act=act)
        return group_norm_cuda(x, weight, bias, film_scale=film_scale, film_shift=film_shift,
                               **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, bias, film_scale, film_shift = ctx.saved_tensors
        grads = group_norm_bwd_cuda(x, weight, bias, grad_out, film_scale=film_scale,
                                    film_shift=film_shift, needs=ctx.needs_input_grad[:5],
                                    **ctx.kw)
        return (*grads, None, None, None)


def group_norm_bytes(x, weight, film_scale=None) -> int:
    """Bytes one call must move, each read once and written once: x in, y out,
    fp32 weight and bias, and the FiLM scale and shift ([N, C] each)."""
    film = 0 if film_scale is None else 2 * film_scale.numel() * film_scale.element_size()
    return 2 * x.numel() * x.element_size() + 8 * weight.numel() + film


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
    # per channel by broadcast, whose gradient is a plain (deterministic) sum
    per_channel = lambda g: g[:, :, None].expand(N, num_groups, C // num_groups).reshape(N, C)
    rstd_c, mean_c = per_channel(rstd_g), per_channel(mean_g)
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


def group_norm_backward_plain(x, weight, bias, grad_out, *, num_groups: int = 32,
                              eps: float = 1e-5, act: str | None = None, film_scale=None,
                              film_shift=None, needs=(True,) * 5):
    """Plain PyTorch version of :func:`group_norm_bwd_cuda`: the gradients of
    :func:`group_norm_plain` for (x, weight, bias, film_scale, film_shift), None
    where ``needs`` says no, in closed form and in the kernel's order of
    operations (fp32 throughout; dx in x's dtype, the FiLM gradients in theirs,
    weight and bias fp32)."""
    N, C = x.shape[:2]
    if C % num_groups != 0:
        raise ValueError(f"channels {C} not divisible by num_groups {num_groups}")
    G, cpg = num_groups, C // num_groups
    xf = x.float().reshape(N, G, cpg, -1)
    dz = grad_out.float().reshape(N, G, cpg, -1)
    span = cpg * xf.shape[-1]
    mean = xf.sum((2, 3)) / span  # [N, G]
    var = (xf * xf).sum((2, 3)) / span - mean * mean
    rstd = torch.rsqrt(var + eps)
    w, b = weight.float().reshape(1, G, cpg), bias.float().reshape(1, G, cpg)
    f1, gsh = 1.0, b
    if film_scale is not None:
        f1 = 1.0 + film_scale.float().reshape(N, G, cpg)
        gsh = b * f1 + film_shift.float().reshape(N, G, cpg)
    gsc = (w * f1).expand(N, G, cpg)  # d z / d xhat per (n, c)
    if act == "silu":
        s = gsc * rstd[..., None]
        z = xf * s[..., None] + (gsh - mean[..., None] * s)[..., None]
        sg = torch.sigmoid(z)
        dz = dz * (sg * (z * (1.0 - sg) + 1.0))
    xhat = (xf - mean[..., None, None]) * rstd[..., None, None]
    s1, s2 = dz.sum(-1), (dz * xhat).sum(-1)  # [N, G, cpg]
    grads = [None] * 5
    if needs[0]:
        m1 = (gsc * s1).sum(-1) / span
        m2 = (gsc * s2).sum(-1) / span
        dx = rstd[..., None, None] * (gsc[..., None] * dz
                                      - (xhat * m2[..., None, None] + m1[..., None, None]))
        grads[0] = dx.reshape(x.shape).to(x.dtype)
    if needs[1]:
        grads[1] = (f1 * s2).reshape(N, C).sum(0)
    if needs[2]:
        grads[2] = (f1 * s1).reshape(N, C).sum(0)
    if film_scale is not None:
        if needs[3]:
            grads[3] = (w * s2 + b * s1).reshape(N, C).to(film_scale.dtype)
        if needs[4]:
            grads[4] = s1.reshape(N, C).to(film_shift.dtype)
    return tuple(grads)


# K1's launch limits (csrc/group_norm.cu)
THREADS = 512
MAX_CHUNKS = 8
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_DYN_SMEM = 232_448 - 1024  # of a block's 227 KB; the kernel's static arrays take the rest
PAIR_BUDGET = 96 * 1024  # slice bytes per CTA at which two CTAs share an SM
CHUNK_BYTES = 16 * 1024  # bulk-copy chunk the stats pass starts on
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


class GroupNormPlan(NamedTuple):
    """K1's launch for x [N, C, hw]: one cluster of ``cs`` CTAs per (n, group)
    span of ``span = cpg * hw`` elements. CTA ``rank`` of a cluster owns the
    slice ``[rank * per, min((rank + 1) * per, span))`` of its span and holds its
    first ``keep`` elements in shared memory (``overflow`` more are read twice).
    With ``bulk`` the held part arrives as 1-D bulk copies of ``chunk`` elements
    (at most ``nchunks``); else as 16-byte vector loads with scalar edges. The
    per-channel scale and shift (2 x ``cpg`` fp32) start at byte ``sc_off`` of
    the ``smem_bytes`` of dynamic shared memory. ``grid`` is one cluster per
    span; the launch holds as many of them as the card runs at once
    (:func:`_launch_shape`), each walking the spans grid-stride. The field
    order is the C entry's layout (:meth:`c_values`)."""
    grid: int
    cs: int
    threads: int
    smem_bytes: int
    sc_off: int
    groups: int
    cpg: int
    hw: int
    span: int
    per: int
    keep: int
    chunk: int
    nchunks: int
    bulk: int
    itemsize: int

    @property
    def overflow(self) -> int:
        """Elements of a full slice that do not fit in shared memory."""
        return self.per - self.keep

    def c_values(self) -> tuple:
        """The 15 values ``group_norm_fwd`` takes, in its order."""
        return tuple(int(v) for v in self)


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


@functools.lru_cache(maxsize=None)
def plan_group_norm(N: int, C: int, hw: int, groups: int, itemsize: int) -> GroupNormPlan:
    """The smallest cluster whose per-CTA slice fits ``PAIR_BUDGET`` (two CTAs
    per SM); else the smallest whose slice fits a CTA's whole shared memory
    (one per SM); else 8 CTAs that each keep what fits and re-read the rest.
    Bulk copies where the span is a whole number of 16-byte vectors."""
    if C % groups:
        raise ValueError(f"channels {C} not divisible by num_groups {groups}")
    cpg = C // groups
    span, vec = cpg * hw, 16 // itemsize
    if not 0 < span < 2 ** 31:
        raise ValueError(f"group span of {span} elements")
    cap = ((MAX_DYN_SMEM - 8 * cpg) // itemsize - vec) // vec * vec  # elements a CTA holds
    if cap < vec:
        raise ValueError(f"{cpg} channels per group leave K1 no shared memory")
    per_of = lambda cs: _round_up(-(-span // cs), vec)
    fits = [cs for cs in CLUSTER_SIZES if per_of(cs) * itemsize <= PAIR_BUDGET] \
        or [cs for cs in CLUSTER_SIZES if per_of(cs) <= cap] or [CLUSTER_SIZES[-1]]
    cs = fits[0]
    per = per_of(cs)
    keep = min(per, cap)
    pieces = min(MAX_CHUNKS, -(-keep * itemsize // CHUNK_BYTES))
    chunk = _round_up(-(-keep // pieces), vec)
    sc_off = _round_up((keep + vec) * itemsize, 16)
    return GroupNormPlan(grid=N * groups * cs, cs=cs, threads=THREADS,
                         smem_bytes=sc_off + 8 * cpg, sc_off=sc_off, groups=groups, cpg=cpg,
                         hw=hw, span=span, per=per, keep=keep, chunk=chunk,
                         nchunks=-(-keep // chunk), bulk=int(span % vec == 0),
                         itemsize=itemsize)


@functools.lru_cache(maxsize=None)
def _launch_shape(plan: GroupNormPlan, dtype: int, device: int):
    """(the plan as the C entry's uint64 array, clusters to launch): as many
    clusters as the card runs at once, at most one per span; each walks the
    spans grid-stride."""
    from bbdm_tpu_torch.kernels import build

    resident = ctypes.c_int(0)
    with torch.cuda.device(device):
        build.check("group_norm_resident_clusters", build.library().group_norm_resident_clusters(
            dtype, plan.cs, plan.smem_bytes, ctypes.byref(resident)))
    if resident.value < 1:
        raise RuntimeError(f"K1: no cluster of {plan.cs} CTAs with {plan.smem_bytes} bytes of "
                           "shared memory fits the card")
    values = plan.c_values()
    return (ctypes.c_uint64 * len(values))(*values), min(plan.grid // plan.cs, resident.value)


@counts_launches
def group_norm_cuda(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5,
                    act: str | None = None, film_scale=None, film_shift=None):
    """Launch K1 once; raises on what it does not take. x: contiguous bf16,
    fp16 or fp32 [N, C, ...]; weight, bias: fp32 [C]; film_*: [N, C] with unit
    channel stride, of x's dtype or fp32."""
    from bbdm_tpu_torch.kernels import build

    if not x.is_cuda:
        raise ValueError("group_norm_cuda takes a CUDA tensor")
    if x.dtype not in _DTYPES:
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
    film = film_scale is not None
    if film:
        for f in (film_scale, film_shift):
            if f.shape != (N, C) or f.stride(1) != 1 or f.device != x.device:
                raise ValueError("group_norm_cuda takes [N, C] film tensors with unit "
                                 "channel stride")
            if f.dtype not in (x.dtype, torch.float32) or f.dtype != film_scale.dtype:
                raise TypeError("group_norm_cuda takes film tensors of x's dtype or fp32")
        if film_scale.stride(0) != film_shift.stride(0):
            raise ValueError("film_scale and film_shift need the same row stride")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    if x.data_ptr() % 16:  # a view at an odd offset; the kernel reads 16-byte vectors
        x = x.clone()
    dtype = _DTYPES[x.dtype]
    c_plan, clusters = _launch_shape(
        plan_group_norm(N, C, x.numel() // (N * C), num_groups, x.element_size()), dtype,
        x.device.index)
    rc = build.library().group_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        film_scale.data_ptr() if film else None, film_shift.data_ptr() if film else None,
        out.data_ptr(), c_plan, clusters, dtype, int(film),
        int(film and film_scale.dtype == torch.float32), film_scale.stride(0) if film else 0,
        int(act == "silu"), eps,
        # the current stream's handle without building a Stream object (~3 us less)
        torch._C._cuda_getCurrentRawStream(x.device.index))
    build.check("group_norm_fwd", rc)
    group_norm_cuda.launches += 1
    return out


# K1's backward (csrc/group_norm_bwd.cu): 16 warps a CTA, and per CTA fp32 scratch
# of 8 values a channel of the group and 2 a warp
BWD_WARPS = THREADS // 32


class GroupNormBwdPlan(NamedTuple):
    """K1 backward's launch for x [N, C, hw]: one cluster of ``cs`` CTAs per
    (n, group) span of ``span = cpg * hw`` elements, ``grid`` CTAs in all. CTA
    ``rank`` owns the slice ``[rank * per, min((rank + 1) * per, span))`` and
    holds its first ``keep`` elements of x (at byte 0) and of dy (at byte
    ``d_off``) in shared memory; ``overflow`` more are read in each of the
    three passes. The fp32 scratch starts at byte ``f_off`` of the
    ``smem_bytes``. ``vec`` is the elements of one access: a 16-byte vector
    where hw is a multiple of one, else 1, so that no access spans two
    channels. The field order is the C entry's layout (:meth:`c_values`)."""
    grid: int
    cs: int
    threads: int
    smem_bytes: int
    d_off: int
    f_off: int
    groups: int
    cpg: int
    hw: int
    span: int
    per: int
    keep: int
    vec: int
    itemsize: int

    @property
    def overflow(self) -> int:
        """Elements of a full slice that do not fit in shared memory."""
        return self.per - self.keep

    def c_values(self) -> tuple:
        """The 14 values ``group_norm_bwd`` takes, in its order."""
        return tuple(int(v) for v in self)


@functools.lru_cache(maxsize=None)
def plan_group_norm_bwd(N: int, C: int, hw: int, groups: int, itemsize: int) -> GroupNormBwdPlan:
    """The forward's rule with x and dy both held: the smallest cluster whose
    per-CTA slices fit ``PAIR_BUDGET`` (two CTAs per SM); else the smallest
    whose slices fit a CTA's shared memory; else 8 CTAs that each hold what
    fits and read the rest again."""
    if C % groups:
        raise ValueError(f"channels {C} not divisible by num_groups {groups}")
    cpg = C // groups
    span, wide = cpg * hw, 16 // itemsize
    if not 0 < span < 2 ** 31:
        raise ValueError(f"group span of {span} elements")
    scratch = 4 * (8 * cpg + 2 * BWD_WARPS)
    cap = (MAX_DYN_SMEM - scratch) // (2 * itemsize) // wide * wide  # elements a CTA holds
    if cap < wide:
        raise ValueError(f"{cpg} channels per group leave K1's backward no shared memory")
    per_of = lambda cs: _round_up(-(-span // cs), wide)
    fits = [cs for cs in CLUSTER_SIZES if 2 * per_of(cs) * itemsize <= PAIR_BUDGET] \
        or [cs for cs in CLUSTER_SIZES if per_of(cs) <= cap] or [CLUSTER_SIZES[-1]]
    cs = fits[0]
    per = per_of(cs)
    keep = min(per, cap)
    d_off = keep * itemsize  # a multiple of 16: keep is of whole vectors
    return GroupNormBwdPlan(grid=N * groups * cs, cs=cs, threads=THREADS,
                            smem_bytes=2 * d_off + scratch, d_off=d_off, f_off=2 * d_off,
                            groups=groups, cpg=cpg, hw=hw, span=span, per=per, keep=keep,
                            vec=wide if hw % wide == 0 else 1, itemsize=itemsize)


@functools.lru_cache(maxsize=None)
def _bwd_c_plan(plan: GroupNormBwdPlan):
    """The plan as the C entry's uint64 array."""
    values = plan.c_values()
    return (ctypes.c_uint64 * len(values))(*values)


@counts_launches
def group_norm_bwd_cuda(x, weight, bias, grad_out, *, num_groups: int = 32, eps: float = 1e-5,
                        act: str | None = None, film_scale=None, film_shift=None,
                        needs=(True,) * 5):
    """K1's backward in one call (the kernel, and where the weight or bias
    gradient is wanted a fold of its [N, C] partials over n): the gradients of
    :func:`group_norm_cuda` for (x, weight, bias, film_scale, film_shift), None
    where ``needs`` says no. Takes what the forward takes, and ``grad_out`` of
    x's shape and dtype (made contiguous here); raises on anything else."""
    from bbdm_tpu_torch.kernels import build

    if not x.is_cuda:
        raise ValueError("group_norm_bwd_cuda takes a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_bwd_cuda: unsupported dtype {x.dtype}")
    if x.ndim < 3 or not x.is_contiguous():
        raise ValueError("group_norm_bwd_cuda takes a contiguous [N, C, ...] tensor")
    if grad_out.shape != x.shape or grad_out.dtype != x.dtype or grad_out.device != x.device:
        raise ValueError("group_norm_bwd_cuda takes grad_out of x's shape, dtype and device")
    N, C = x.shape[:2]
    for p in (weight, bias):
        if p.shape != (C,) or p.dtype != torch.float32 or not p.is_contiguous() \
                or p.device != x.device:
            raise ValueError("group_norm_bwd_cuda takes contiguous fp32 [C] weight and bias")
    film = film_scale is not None
    if film:
        for f in (film_scale, film_shift):
            if f.shape != (N, C) or f.stride(1) != 1 or f.device != x.device \
                    or f.stride(0) != film_scale.stride(0):
                raise ValueError("group_norm_bwd_cuda takes [N, C] film tensors with unit "
                                 "channel stride and one row stride")
            if f.dtype not in (x.dtype, torch.float32) or f.dtype != film_scale.dtype:
                raise TypeError("group_norm_bwd_cuda takes film tensors of x's dtype or fp32")
    grad_out = grad_out.contiguous()
    if x.data_ptr() % 16:  # views at an odd offset; the kernel reads 16-byte vectors
        x = x.clone()
    if grad_out.data_ptr() % 16:
        grad_out = grad_out.clone()
    dev = x.device
    dx = torch.empty_like(x) if needs[0] else None
    dfilm = torch.empty((2, N, C), dtype=film_scale.dtype, device=dev) \
        if film and (needs[3] or needs[4]) else None
    dfs = dfilm[0] if dfilm is not None and needs[3] else None
    dfb = dfilm[1] if dfilm is not None and needs[4] else None
    part = torch.empty((2, N, C), dtype=torch.float32, device=dev) if needs[1] or needs[2] else None
    dwb = torch.empty((2, C), dtype=torch.float32, device=dev) if part is not None else None
    dw = dwb[0] if part is not None and needs[1] else None
    db = dwb[1] if part is not None and needs[2] else None
    if x.numel() == 0:  # no element: every gradient is zero
        return tuple(None if t is None else t.zero_() for t in (dx, dw, db, dfs, dfb))
    ptr = lambda t: None if t is None else t.data_ptr()
    dtype = _DTYPES[x.dtype]
    rc = build.library().group_norm_bwd(
        x.data_ptr(), grad_out.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        ptr(film_scale), ptr(film_shift), ptr(dx), ptr(dfs), ptr(dfb), ptr(part), ptr(dw),
        ptr(db), _bwd_c_plan(plan_group_norm_bwd(N, C, x.numel() // (N * C), num_groups,
                                                 x.element_size())),
        dtype, int(film), int(film and film_scale.dtype == torch.float32),
        film_scale.stride(0) if film else 0, int(act == "silu"), eps,
        torch._C._cuda_getCurrentRawStream(dev.index))
    build.check("group_norm_bwd", rc)
    group_norm_bwd_cuda.launches += 1
    return dx, dw, db, dfs, dfb
