"""UNet building blocks, NCHW (port of ``bbdm_tpu/models/layers.py``), with the
cross-attention family (``CrossAttention``, ``GEGLUFeedForward``,
``BasicTransformerBlock``, ``SpatialTransformer``) and the two other attention
layers (``LinearAttention``, ``SpatialSelfAttention``).

Parameters are fp32; each conv/dense casts its input, weight and bias to its
compute ``dtype`` at use, as flax does (``dtype=None``: the promotion of the
input's and the weight's dtype). GroupNorm statistics and the attention
softmax stay fp32. Attribute names are the flax module names, so
``checkpoints/from_jax.py`` is a rename plus transpose.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from bbdm_tpu_torch.ops import attention as attn_ops
from bbdm_tpu_torch.ops import group_norm as gn_ops
from bbdm_tpu_torch.ops import upsample_conv as up_ops


# ---------------------------------------------------------------- initialisers
# Each takes (tensor, generator) and fills the tensor in place; they mirror the
# flax initialisers of bbdm_tpu/models/layers.py.

def normal_init(t, g):
    """N(0, 0.02): the reference's weights_init for Conv2d/Linear."""
    t.normal_(0.0, 0.02, generator=g)


def torch_default_init(t, g):
    """U(+-1/sqrt(fan_in)): torch's default conv/linear weight init."""
    bound = 1.0 / math.sqrt(t[0].numel())
    t.uniform_(-bound, bound, generator=g)


def zeros_init(t, g):
    t.zero_()


def lecun_normal_init(fan_in):
    """flax's default Dense kernel init: a normal truncated at +-2 std with
    variance 1/fan_in after the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978

    def init(t, g):
        torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
    return init


def head_init(scheme: str):
    """Init of output-projection convs: 'reference' N(0,0.02), 'zero_heads' zeros."""
    if scheme == "reference":
        return normal_init
    if scheme == "zero_heads":
        return zeros_init
    raise ValueError(f"unknown init_scheme {scheme!r}")


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` from its layer's initialiser."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _Init):
                m.init_from(generator)


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """``module`` in eval mode for the block, its earlier mode restored after it."""
    was_training = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was_training)


class _Init(nn.Module):
    """A layer that owns parameters and knows their initialisers."""

    def init_from(self, g):
        raise NotImplementedError


def _dt(dtype, x, w):
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, cos first: [cos(t f), sin(t f)], f = exp(-log(P) i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(_Init):
    """GroupNorm(32) with fp32 statistics, optional fused SiLU / FiLM."""

    def __init__(self, channels, num_groups=32, eps=1e-5, *, device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def init_from(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, *, act=None, film_scale=None, film_shift=None):
        return gn_ops.group_norm(x, self.weight, self.bias, num_groups=self.num_groups,
                                 eps=self.eps, act=act, film_scale=film_scale,
                                 film_shift=film_shift)


class Conv2d(_Init):
    """flax ``nn.Conv`` semantics: compute in ``dtype``, symmetric ``padding``,
    ``bias=False`` for ``use_bias=False``."""

    def __init__(self, in_ch, out_ch, kernel, *, stride=1, padding=0, init=normal_init,
                 dtype=None, bias=True, device=None):
        super().__init__()
        self.stride, self.padding, self.dtype, self._init = stride, padding, dtype, init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device)) if bias else None

    def init_from(self, g):
        self._init(self.weight, g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dt = _dt(self.dtype, x, self.weight)
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, stride=self.stride,
                        padding=self.padding)


def conv3x3(in_ch, out_ch, *, init=normal_init, dtype=None, stride=1, device=None):
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, init=init, dtype=dtype,
                  device=device)


def conv1x1(in_ch, out_ch, *, init=normal_init, dtype=None, bias=True, device=None):
    return Conv2d(in_ch, out_ch, 1, init=init, dtype=dtype, bias=bias, device=device)


class Dense(_Init):
    """flax ``nn.Dense`` semantics over the last axis; ``bias=False`` for
    ``use_bias=False``."""

    def __init__(self, in_f, out_f, *, init=normal_init, dtype=None, bias=True, device=None):
        super().__init__()
        self.dtype, self._init = dtype, init
        self.weight = nn.Parameter(torch.empty(out_f, in_f, device=device))
        self.bias = nn.Parameter(torch.empty(out_f, device=device)) if bias else None

    def init_from(self, g):
        self._init(self.weight, g)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dt = _dt(self.dtype, x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt),
                        self.bias.to(dt) if self.bias is not None else None)


def upsample_nearest_2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x(x):
    return F.avg_pool2d(x, 2)


class UpsampleConv3x3(_Init):
    """``conv3x3(upsample_nearest_2x(x))`` through the subpixel decomposition
    (eval form). ``combined``: the phase kernel in the compute dtype, set by
    the sampler for the length of one call (models/bridge.py) so the combine
    runs once per call, not per step; None combines in the call.

    In training mode it is the naive upsample + conv + bias, the JAX package's
    own training form (``bbdm_tpu/models/layers.py:139-148``): the combine
    cannot be hoisted when the weights change every step."""

    def __init__(self, in_ch, out_ch, *, init=normal_init, dtype=None, device=None):
        super().__init__()
        self.dtype, self._init = dtype, init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))
        self.combined = None

    def init_from(self, g):
        self._init(self.weight, g)
        self.bias.zero_()

    def forward(self, x):
        if self.training:
            dt = _dt(self.dtype, x, self.weight)
            out = F.conv2d(upsample_nearest_2x(x).to(dt), self.weight.to(dt), padding=1)
            return out + self.bias.to(out.dtype)[:, None, None]
        return up_ops.upsample2x_conv3x3(x, self.weight, self.bias, dtype=self.dtype,
                                         combined=self.combined)


class Upsample(nn.Module):
    """2x nearest upsample, optionally followed by a 3x3 conv (``conv``)."""

    def __init__(self, ch, use_conv=True, *, dtype=None, device=None):
        super().__init__()
        self.conv = UpsampleConv3x3(ch, ch, dtype=dtype, device=device) if use_conv else None

    def forward(self, x):
        return self.conv(x) if self.conv is not None else upsample_nearest_2x(x)


class Downsample(nn.Module):
    """Stride-2 3x3 conv (``op``) or 2x average pool."""

    def __init__(self, ch, use_conv=True, *, dtype=None, device=None):
        super().__init__()
        self.op = conv3x3(ch, ch, stride=2, dtype=dtype, device=device) if use_conv else None

    def forward(self, x):
        return self.op(x) if self.op is not None else avg_pool_2x(x)


class ResBlock(nn.Module):
    """Timestep-conditioned residual block (``bbdm_tpu/models/layers.py:196-248``).

    in: GN -> SiLU -> [up: subpixel up-conv | down: avg-pool, conv3x3 | conv3x3];
    emb: SiLU -> Dense (2*out when scale-shift: [scale, shift] into the out GN);
    out: GN [FiLM] -> SiLU -> dropout (training mode only) -> conv3x3; skip:
    identity or 1x1 conv, with the same up (nearest) / down (avg-pool)
    resampling.
    """

    def __init__(self, in_ch, out_ch, emb_ch, *, use_scale_shift_norm=False, up=False,
                 down=False, dropout=0.0, init_scheme="reference", dtype=None, device=None):
        super().__init__()
        self.up, self.down, self.use_scale_shift_norm = up, down, use_scale_shift_norm
        self.dropout = dropout
        kw = dict(dtype=dtype, device=device)
        self.in_norm = GroupNorm32(in_ch, device=device)
        if up:
            self.in_conv = UpsampleConv3x3(in_ch, out_ch, **kw)
        else:
            self.in_conv = conv3x3(in_ch, out_ch, **kw)
        self.emb_proj = Dense(emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch, **kw)
        self.out_norm = GroupNorm32(out_ch, device=device)
        self.out_conv = conv3x3(out_ch, out_ch, init=head_init(init_scheme), **kw)
        self.skip = conv1x1(in_ch, out_ch, **kw) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_norm(x, act="silu")
        if self.up:
            x = upsample_nearest_2x(x)
        elif self.down:
            h = avg_pool_2x(h)
            x = avg_pool_2x(x)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_norm(h, act="silu", film_scale=scale, film_shift=shift)
        else:
            h = h + emb_out[:, :, None, None].to(h.dtype)
            h = self.out_norm(h, act="silu")
        if self.dropout > 0.0:
            h = F.dropout(h, self.dropout, training=self.training)
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over H*W tokens with the legacy per-head
    ``[q | k | v]`` channel split (``bbdm_tpu/models/layers.py:251-276``)."""

    def __init__(self, ch, num_heads, *, dtype=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(ch, device=device)
        self.qkv = Dense(ch, 3 * ch, init=torch_default_init, dtype=dtype, device=device)
        self.proj_out = Dense(ch, ch, init=zeros_init, dtype=dtype, device=device)

    def forward(self, x):
        B, C, H, W = x.shape
        T = H * W
        h = self.norm(x).reshape(B, C, T).transpose(1, 2)  # [B, T, C]
        qkv = self.qkv(h).reshape(B, T, self.num_heads, 3, C // self.num_heads)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2).contiguous() for i in range(3))
        a = attn_ops.multi_head_attention(q, k, v)  # [B, heads, T, d]
        a = self.proj_out(a.transpose(1, 2).reshape(B, T, C))
        return x + a.transpose(1, 2).reshape(B, C, H, W)


# ------------------------------------------------------- transformer family
# bbdm_tpu/models/layers.py:279-412. Token tensors are [B, T, C] as in flax;
# image tensors NCHW, whose tokens are taken in row-major (h, w) order, the
# order of flax's NHWC reshape.

def tokens(x):
    """NCHW [B, C, H, W] -> [B, H*W, C], tokens in row-major (h, w) order."""
    return x.flatten(2).transpose(1, 2)


def untokens(t, H, W):
    """[B, H*W, C] -> NCHW-contiguous [B, C, H, W] (the kernels take NCHW)."""
    return t.transpose(1, 2).contiguous().view(t.shape[0], t.shape[2], H, W)


class LayerNorm(_Init):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6, fp32 ``weight``
    (flax ``scale``) and ``bias``, the mean of x and of x^2 in fp32 (flax's fast
    variance, clipped at 0), and an fp32 output whatever x's dtype (flax's
    result type of a bf16 x and fp32 parameters)."""

    def __init__(self, features, eps=1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def init_from(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        return (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class CrossAttention(nn.Module):
    """Multi-head attention of x's tokens over the context's
    (``bbdm_tpu/models/layers.py:325-349``); self-attention where the context
    is None. Bias-free ``to_q``/``to_k``/``to_v``, biased ``to_out``. A 4-D
    (NCHW) context becomes its H*W tokens. flax infers ``to_k``/``to_v``'s input
    width from the context; here it is ``context_dim`` (None: the query width),
    and a context of another width raises."""

    def __init__(self, query_dim, heads, dim_head, out_dim, *, context_dim=None, dtype=None,
                 device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        kw = dict(bias=False, dtype=dtype, device=device)
        self.to_q = Dense(query_dim, inner, **kw)
        self.to_k = Dense(context_dim or query_dim, inner, **kw)
        self.to_v = Dense(context_dim or query_dim, inner, **kw)
        self.to_out = Dense(inner, out_dim, dtype=dtype, device=device)

    def forward(self, x, context=None):
        """x: [B, Tq, C]; context: None, [B, Tk, C'] or [B, C', H, W]."""
        ctx = x if context is None else context
        if ctx.ndim == 4:
            ctx = tokens(ctx)
        width = self.to_k.weight.shape[1]
        if ctx.shape[-1] != width:
            raise ValueError(f"CrossAttention: the context has {ctx.shape[-1]} channels, to_k "
                             f"and to_v take {width} (set UNetParams.context_dim to the "
                             "context's channels)")
        B, T = x.shape[:2]

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, self.dim_head) \
                .transpose(1, 2).contiguous()

        out = attn_ops.multi_head_attention(heads(self.to_q(x)), heads(self.to_k(ctx)),
                                            heads(self.to_v(ctx)))
        return self.to_out(out.transpose(1, 2).reshape(B, T, self.heads * self.dim_head))


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward (``bbdm_tpu/models/layers.py:352-365``): ``proj`` to
    2 x mult x dim, value times tanh-GELU(gate) (flax ``nn.gelu``), ``out``."""

    def __init__(self, dim, mult=4, *, dtype=None, device=None):
        super().__init__()
        self.proj = Dense(dim, 2 * mult * dim, dtype=dtype, device=device)
        self.out = Dense(mult * dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    """Pre-LayerNorm self-attention, cross-attention and GEGLU feed-forward,
    each added to its input (``bbdm_tpu/models/layers.py:368-387``)."""

    def __init__(self, dim, heads, dim_head, *, context_dim=None, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.attn1 = CrossAttention(dim, heads, dim_head, dim, **kw)
        self.norm2 = LayerNorm(dim, device=device)
        self.attn2 = CrossAttention(dim, heads, dim_head, dim, context_dim=context_dim, **kw)
        self.norm3 = LayerNorm(dim, device=device)
        self.ff = GEGLUFeedForward(dim, **kw)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6, through K1) -> 1x1 ``proj_in`` -> ``depth``
    transformer blocks over the H*W tokens -> 1x1 ``proj_out`` (head init),
    added to x (``bbdm_tpu/models/layers.py:390-412``)."""

    def __init__(self, ch, heads, dim_head, *, depth=1, context_dim=None,
                 init_scheme="reference", dtype=None, device=None):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm32(ch, eps=1e-6, device=device)
        self.proj_in = conv1x1(ch, inner, dtype=dtype, device=device)
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim=context_dim, dtype=dtype, device=device))
        self.proj_out = conv1x1(inner, ch, init=head_init(init_scheme), dtype=dtype,
                                device=device)

    def forward(self, x, context=None):
        H, W = x.shape[-2:]
        h = tokens(self.proj_in(self.norm(x)))
        for d in range(self.depth):
            h = self.get_submodule(f"block_{d}")(h, context)
        return x + self.proj_out(untokens(h, H, W))


class LinearAttention(nn.Module):
    """Kernelised attention (``bbdm_tpu/models/layers.py:279-300``): 1x1
    ``to_qkv``, the keys' softmax over tokens in fp32 (rounded to x's dtype),
    context = k^T v per head, out = q context, 1x1 ``to_out``; no norm, no
    residual."""

    def __init__(self, ch, heads=4, dim_head=32, *, dtype=None, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = conv1x1(ch, 3 * inner, init=torch_default_init, dtype=dtype, device=device)
        self.to_out = conv1x1(inner, ch, init=torch_default_init, dtype=dtype, device=device)

    def forward(self, x):
        B, _, H, W = x.shape
        qkv = tokens(self.to_qkv(x)).reshape(B, H * W, 3, self.heads, self.dim_head)
        q, k, v = qkv.unbind(2)  # each [B, T, heads, d]
        k = torch.softmax(k.float(), dim=1).to(x.dtype)
        context = torch.einsum("bthd,bthe->bhde", k, v)
        out = torch.einsum("bhde,bthd->bthe", context, q)
        return self.to_out(untokens(out.reshape(B, H * W, self.heads * self.dim_head), H, W))


class SpatialSelfAttention(nn.Module):
    """One-head self-attention with 1x1 ``q``/``k``/``v`` convs
    (``bbdm_tpu/models/layers.py:303-322``): GroupNorm eps 1e-6 (K1), logits in
    fp32 scaled by C^-1/2, an fp32 softmax rounded to x's dtype, 1x1
    ``proj_out``, added to x. Not through ``multi_head_attention``: it has its
    own scale."""

    def __init__(self, ch, *, dtype=None, device=None):
        super().__init__()
        kw = dict(init=torch_default_init, dtype=dtype, device=device)
        self.norm = GroupNorm32(ch, eps=1e-6, device=device)
        self.q, self.k, self.v = (conv1x1(ch, ch, **kw) for _ in range(3))
        self.proj_out = conv1x1(ch, ch, **kw)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (tokens(m(h)) for m in (self.q, self.k, self.v))
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (C ** -0.5)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        return x + self.proj_out(untokens(torch.matmul(w, v), H, W))


# ------------------------------------------------------------ embedders' layers

class Embed(_Init):
    """flax ``nn.Embed``: a table ``embedding`` [num, features] drawn from
    N(0, std^2); integer ids -> rows, fp32."""

    def __init__(self, num, features, *, std=1.0, device=None):
        super().__init__()
        self.std = std
        self.embedding = nn.Parameter(torch.empty(num, features, device=device))

    def init_from(self, g):
        self.embedding.normal_(0.0, self.std, generator=g)

    def forward(self, ids):
        return self.embedding[ids.long()]


class DenseGeneral(_Init):
    """flax ``nn.DenseGeneral`` as ``MultiHeadDotProductAttention`` uses it: the
    last ``len(in_shape)`` axes of x contracted with ``weight``'s leading ones,
    ``weight`` in flax's layout (in_shape + out_shape, e.g. [C, heads, d] or
    [heads, d, C]), ``bias`` out_shape; computed in ``dtype``."""

    def __init__(self, in_shape, out_shape, *, dtype=None, device=None):
        super().__init__()
        self.dtype, self.n_in = dtype, len(in_shape)
        self.weight = nn.Parameter(torch.empty(*in_shape, *out_shape, device=device))
        self.bias = nn.Parameter(torch.empty(*out_shape, device=device))

    def init_from(self, g):
        lecun_normal_init(math.prod(self.weight.shape[:self.n_in]))(self.weight, g)
        self.bias.zero_()

    def forward(self, x):
        dt = _dt(self.dtype, x, self.weight)
        return torch.tensordot(x.to(dt), self.weight.to(dt), dims=self.n_in) + self.bias.to(dt)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (biased ``query``, ``key``,
    ``value`` [C, heads, C/heads] and ``out`` [heads, C/heads, C]
    ``DenseGeneral``s; q scaled by 1/sqrt(C/heads), logits and softmax in the
    compute dtype, no dropout) over one input attending to itself."""

    def __init__(self, features, num_heads, *, dtype=None, device=None):
        super().__init__()
        d = features // num_heads
        kw = dict(dtype=dtype, device=device)
        self.query, self.key, self.value = (DenseGeneral((features,), (num_heads, d), **kw)
                                            for _ in range(3))
        self.out = DenseGeneral((num_heads, d), (features,), **kw)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, T, heads, d]
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))
