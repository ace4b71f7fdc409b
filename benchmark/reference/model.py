"""A plain PyTorch LBBDM: the VQGAN encoder, quantizer and decoder, the
guided-diffusion UNet, the Brownian-bridge schedule, the euler skip-step
sampler and the training loss, written from the BBDM paper (arXiv 2205.07680)
and its published templates, in float32 with plain operations.

The weights are a flat ``{name: tensor}`` dict whose names follow the
layout of the published templates' modules (``unet.down_0_0.in_norm.weight``,
``vqgan.encoder.mid_attn_1.q.weight``, ...). Every parameter is asked for
through :class:`Params`, so running a forward pass on the meta device in spec
mode lists every parameter with its shape and kind (:func:`param_specs`).

The five operations that carry the arithmetic (conv, linear, group norm, the
nearest-2x up-conv and attention) go through an :class:`Ops` object: :class:`Ops` is the float32
reference, ``lowp.Fp8Ops`` the lower-precision control and
``roofline.Recorder`` the meta-device walk that lists the calls a kernel
would serve.

Departures from the published code, each also made by the measured program:
the decoder's quantizer is the nearest code in float32; the UNet's time MLP
runs in float32; GroupNorm statistics and the attention softmax are float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ operations

class Ops:
    """The float32 reference operations."""

    def conv(self, x, w, b, stride=1, padding=0):
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def group_norm(self, x, w, b, eps, silu=True, scale=None, shift=None):
        N, C = x.shape[:2]
        xg = x.reshape(N, 32, -1)
        mean = xg.mean(-1, keepdim=True)
        var = xg.var(-1, unbiased=False, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
        y = y * w[None, :, None, None] + b[None, :, None, None]
        if scale is not None:
            y = y * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None]
        return F.silu(y) if silu else y

    def upconv(self, x, w, b):
        """conv3x3(nearest_2x(x)) + b."""
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"), w, b, padding=1)

    def attention(self, q, k, v):
        """softmax(q k^T / sqrt(D)) v over [B, H, T, D]."""
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        return torch.matmul(torch.softmax(logits, dim=-1), v)


class Params:
    """The weights by name. In spec mode (``weights`` None) each request is
    recorded as (name, shape, kind) and answered with a meta tensor."""

    def __init__(self, weights=None):
        self.weights = weights
        self.specs: dict = {}

    def __call__(self, name, shape, kind):
        if self.weights is None:
            self.specs.setdefault(name, (tuple(shape), kind))
            return torch.empty(shape, device="meta")
        w = self.weights[name]
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(w.shape)}, expected {tuple(shape)}")
        return w


# ---------------------------------------------------------------- shared layers

def _conv(P, ops, name, x, cin, cout, k, stride=1, padding=None):
    w = P(f"{name}.weight", (cout, cin, k, k), "conv")
    b = P(f"{name}.bias", (cout,), "bias")
    return ops.conv(x, w, b, stride=stride, padding=k // 2 if padding is None else padding)


def _norm(P, ops, name, x, eps, silu=True, scale=None, shift=None):
    C = x.shape[1]
    return ops.group_norm(x, P(f"{name}.weight", (C,), "norm_w"),
                          P(f"{name}.bias", (C,), "norm_b"), eps, silu, scale, shift)


def _upconv(P, ops, name, x, cin, cout):
    return ops.upconv(x, P(f"{name}.weight", (cout, cin, 3, 3), "conv"),
                      P(f"{name}.bias", (cout,), "bias"))


def _dense(P, ops, name, x, fin, fout, kind="dense"):
    return ops.linear(x, P(f"{name}.weight", (fout, fin), kind), P(f"{name}.bias", (fout,), "bias"))


# ----------------------------------------------------------------------- VQGAN

def _vq_res(P, ops, name, x, cin, cout):
    h = _conv(P, ops, f"{name}.conv1", _norm(P, ops, f"{name}.norm1", x, 1e-6), cin, cout, 3)
    h = _conv(P, ops, f"{name}.conv2", _norm(P, ops, f"{name}.norm2", h, 1e-6), cout, cout, 3)
    if cin != cout:
        x = _conv(P, ops, f"{name}.nin_shortcut", x, cin, cout, 1)
    return x + h


def _vq_attn(P, ops, name, x):
    B, C, H, W = x.shape
    h = _norm(P, ops, f"{name}.norm", x, 1e-6, silu=False)
    q, k, v = (_conv(P, ops, f"{name}.{n}", h, C, C, 1).reshape(B, 1, C, H * W).transpose(2, 3)
               for n in "qkv")
    a = ops.attention(q, k, v).transpose(2, 3).reshape(B, C, H, W)
    return x + _conv(P, ops, f"{name}.proj_out", a, C, C, 1)


def vq_encode(P, ops, x, vq):
    """Image [B, 3, H, W] -> the latent before quantization (encoder, quant_conv)."""
    dd, p = vq["ddconfig"], "vqgan.encoder"
    ch, mults, nrb = dd["ch"], tuple(dd["ch_mult"]), dd["num_res_blocks"]
    h = _conv(P, ops, f"{p}.conv_in", x, dd["in_channels"], ch, 3)
    cin, res = ch, dd["resolution"]
    for lvl, m in enumerate(mults):
        for blk in range(nrb):
            h = _vq_res(P, ops, f"{p}.down_{lvl}_block_{blk}", h, cin, ch * m)
            cin = ch * m
            if res in dd["attn_resolutions"]:
                h = _vq_attn(P, ops, f"{p}.down_{lvl}_attn_{blk}", h)
        if lvl != len(mults) - 1:
            h = _conv(P, ops, f"{p}.down_{lvl}_downsample.conv", F.pad(h, (0, 1, 0, 1)),
                      cin, cin, 3, stride=2, padding=0)
            res //= 2
    h = _vq_res(P, ops, f"{p}.mid_block_1", h, cin, cin)
    h = _vq_attn(P, ops, f"{p}.mid_attn_1", h)
    h = _vq_res(P, ops, f"{p}.mid_block_2", h, cin, cin)
    h = _norm(P, ops, f"{p}.norm_out", h, 1e-6)
    z = _conv(P, ops, f"{p}.conv_out", h.float(), cin, dd["z_channels"], 3)
    return _conv(P, ops, "vqgan.quant_conv", z, dd["z_channels"], vq["embed_dim"], 1)


def vq_quantize(P, z, vq):
    """The nearest codebook entry of each latent position, in float32."""
    B, C, H, W = z.shape
    e = P("vqgan.quantize.embedding", (vq["n_embed"], vq["embed_dim"]), "codebook").float()
    flat = z.float().permute(0, 2, 3, 1).reshape(-1, C)
    if flat.is_meta:
        return z
    idx = torch.cat([((f[:, None, :] - e[None]) ** 2).sum(-1).argmin(1)
                     for f in flat.split(1024)])
    return e[idx].reshape(B, H, W, C).permute(0, 3, 1, 2)


def vq_decode(P, ops, zq, vq):
    """Quantized latent -> image (post_quant_conv, decoder)."""
    dd, p = vq["ddconfig"], "vqgan.decoder"
    ch, mults, nrb = dd["ch"], tuple(dd["ch_mult"]), dd["num_res_blocks"]
    z = _conv(P, ops, "vqgan.post_quant_conv", zq, vq["embed_dim"], dd["z_channels"], 1)
    cin = ch * mults[-1]
    res = dd["resolution"] // 2 ** (len(mults) - 1)
    h = _conv(P, ops, f"{p}.conv_in", z, dd["z_channels"], cin, 3)
    h = _vq_res(P, ops, f"{p}.mid_block_1", h, cin, cin)
    h = _vq_attn(P, ops, f"{p}.mid_attn_1", h)
    h = _vq_res(P, ops, f"{p}.mid_block_2", h, cin, cin)
    for lvl in reversed(range(len(mults))):
        for blk in range(nrb + 1):
            h = _vq_res(P, ops, f"{p}.up_{lvl}_block_{blk}", h, cin, ch * mults[lvl])
            cin = ch * mults[lvl]
            if res in dd["attn_resolutions"]:
                h = _vq_attn(P, ops, f"{p}.up_{lvl}_attn_{blk}", h)
        if lvl != 0:
            h = _upconv(P, ops, f"{p}.up_{lvl}_upsample.conv", h, cin, cin)
            res *= 2
    h = _norm(P, ops, f"{p}.norm_out", h, 1e-6)
    return _conv(P, ops, f"{p}.conv_out", h.float(), cin, dd["out_ch"], 3)


# ------------------------------------------------------------------------ UNet

def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _unet_res(P, ops, name, x, emb, cin, cout, emb_ch, up=False, down=False):
    h = _norm(P, ops, f"{name}.in_norm", x, 1e-5)
    if up:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        h = _upconv(P, ops, f"{name}.in_conv", h, cin, cout)
    else:
        if down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = _conv(P, ops, f"{name}.in_conv", h, cin, cout, 3)
    e = _dense(P, ops, f"{name}.emb_proj", F.silu(emb), emb_ch, 2 * cout)
    scale, shift = e.chunk(2, dim=1)
    h = _norm(P, ops, f"{name}.out_norm", h, 1e-5, scale=scale, shift=shift)
    h = _conv(P, ops, f"{name}.out_conv", h, cout, cout, 3)
    if cin != cout:
        x = _conv(P, ops, f"{name}.skip", x, cin, cout, 1)
    return x + h


def _unet_attn(P, ops, name, x, heads):
    B, C, H, W = x.shape
    T = H * W
    h = _norm(P, ops, f"{name}.norm", x, 1e-5, silu=False).reshape(B, C, T).transpose(1, 2)
    qkv = _dense(P, ops, f"{name}.qkv", h, C, 3 * C).reshape(B, T, heads, 3, C // heads)
    q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    a = ops.attention(q, k, v).transpose(1, 2).reshape(B, T, C)
    a = _dense(P, ops, f"{name}.proj_out", a, C, C)
    return x + a.transpose(1, 2).reshape(B, C, H, W)


def unet(P, ops, x, t, u):
    """The noise-free UNet of the templates (``condition_key: nocond``,
    scale-shift norm, ResBlock up/down sampling)."""
    if not (u["use_scale_shift_norm"] and u["resblock_updown"] and u["condition_key"] == "nocond"
            and not u.get("use_spatial_transformer", False)):
        raise NotImplementedError("the reference UNet is the templates' nocond, scale-shift, "
                                  "ResBlock-resampling UNet")
    mc, mults, nrb = u["model_channels"], tuple(u["channel_mult"]), u["num_res_blocks"]
    attn_res, emb_ch = tuple(u["attention_resolutions"]), 4 * mc

    def heads(ch):
        return ch // u["num_head_channels"] if u["num_head_channels"] != -1 else u["num_heads"]

    emb = _dense(P, ops, "unet.time_dense_0", timestep_embedding(t, mc), mc, emb_ch)
    emb = _dense(P, ops, "unet.time_dense_1", F.silu(emb), emb_ch, emb_ch)
    h = _conv(P, ops, "unet.stem", x, u["in_channels"], mc, 3)
    hs, ch, ds = [h], mc, 1
    for lvl, m in enumerate(mults):
        for i in range(nrb):
            h = _unet_res(P, ops, f"unet.down_{lvl}_{i}", h, emb, ch, m * mc, emb_ch)
            ch = m * mc
            if ds in attn_res:
                h = _unet_attn(P, ops, f"unet.down_{lvl}_{i}_attn", h, heads(ch))
            hs.append(h)
        if lvl != len(mults) - 1:
            h = _unet_res(P, ops, f"unet.down_{lvl}_ds", h, emb, ch, ch, emb_ch, down=True)
            hs.append(h)
            ds *= 2
    h = _unet_res(P, ops, "unet.mid_res_0", h, emb, ch, ch, emb_ch)
    h = _unet_attn(P, ops, "unet.mid_attn", h, heads(ch))
    h = _unet_res(P, ops, "unet.mid_res_1", h, emb, ch, ch, emb_ch)
    for lvl, m in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            skip = hs.pop()
            h = _unet_res(P, ops, f"unet.up_{lvl}_{i}", torch.cat([h, skip], dim=1), emb,
                          ch + skip.shape[1], m * mc, emb_ch)
            ch = m * mc
            if ds in attn_res:
                h = _unet_attn(P, ops, f"unet.up_{lvl}_{i}_attn", h, heads(ch))
            if lvl and i == nrb:
                h = _unet_res(P, ops, f"unet.up_{lvl}_us", h, emb, ch, ch, emb_ch, up=True)
                ds //= 2
    h = _norm(P, ops, "unet.out_norm", h, 1e-5)
    return _conv(P, ops, "unet.out_conv", h.float(), ch, u["out_channels"], 3)


# ------------------------------------------------------------------- the bridge

def bridge_schedule(bb):
    """(m_t, variance_t) float64 of the linear m_t schedule."""
    if bb["mt_type"] != "linear":
        raise NotImplementedError("mt_type linear")
    m = np.linspace(0.001, 0.999, bb["num_timesteps"], dtype=np.float64)
    return m, 2.0 * (m - m ** 2) * bb.get("max_var", 1.0)


def sampling_steps(bb):
    """The linear skip grid: sample_step - 2 evenly spaced steps, then 1 and 0."""
    if not (bb["skip_sample"] and bb["sample_type"] == "linear"):
        raise NotImplementedError("skip_sample with sample_type linear")
    T, S = bb["num_timesteps"], bb["sample_step"]
    mid = np.arange(T - 1, 1, step=-((T - 1) / (S - 2)), dtype=np.float64).astype(np.int64)
    return np.concatenate([mid, [1, 0]])


def sampler_coeffs(bb):
    """Per step (t, a_xt, a_x0, a_y, sigma) of the reverse bridge posterior,
    x_next = a_xt x_t + a_x0 x0 + a_y y + sigma eps, in float64."""
    m, var = bridge_schedule(bb)
    steps = sampling_steps(bb)
    eta = bb.get("eta", 1.0)
    out = []
    for i, t in enumerate(steps):
        if t == 0:
            out.append((0, 0.0, 1.0, 0.0, 0.0))
            continue
        nt = steps[i + 1]
        s2 = (var[t] - var[nt] * (1 - m[t]) ** 2 / (1 - m[nt]) ** 2) * var[nt] / var[t]
        s2 = max(s2, 0.0)
        a = math.sqrt(max(var[nt] - s2, 0.0) / var[t])
        out.append((int(t), a, (1 - m[nt]) - a * (1 - m[t]), m[nt] - a * m[t],
                    eta * math.sqrt(s2)))
    return out


def check_objective(bb):
    if bb["objective"] != "grad" or bb["loss_type"] != "l1":
        raise NotImplementedError("objective grad with loss_type l1")


def sample_latent(P, ops, y, noise, model_cfg):
    """The reverse bridge from x_T = y: one UNet forward and one update per
    step, ``noise[i]`` the step's noise; returns the final latent."""
    bb = model_cfg["BB"]["params"]
    check_objective(bb)
    x = y
    for i, (t, a_xt, a_x0, a_y, sigma) in enumerate(sampler_coeffs(bb)):
        tt = torch.full((y.shape[0],), t, dtype=torch.long, device=y.device)
        x0 = x - unet(P, ops, x, tt, bb["UNetParams"]).float()
        x = a_xt * x + a_x0 * x0 + a_y * y
        if sigma:
            x = x + sigma * noise[i]
    return x


def train_loss(P, ops, x, y, t, noise, model_cfg):
    """The l1 loss of the grad objective at timesteps ``t`` with ``noise``."""
    bb = model_cfg["BB"]["params"]
    check_objective(bb)
    vq = model_cfg["VQGAN"]["params"]
    with torch.no_grad():
        x0, yl = vq_encode(P, ops, x, vq), vq_encode(P, ops, y, vq)
    m, var = bridge_schedule(bb)
    m_t = torch.as_tensor(m.astype(np.float32), device=x.device)[t].reshape(-1, 1, 1, 1)
    s_t = torch.sqrt(torch.as_tensor(var.astype(np.float32), device=x.device)[t]).reshape(-1, 1, 1, 1)
    x_t = (1.0 - m_t) * x0 + m_t * yl + s_t * noise
    objective = m_t * (yl - x0) + s_t * noise
    return (objective - unet(P, ops, x_t, t, bb["UNetParams"]).float()).abs().mean()


def param_specs(model_cfg) -> dict:
    """{name: (shape, kind)} of every weight, in the order a forward pass asks for them."""
    vq, u = model_cfg["VQGAN"]["params"], model_cfg["BB"]["params"]["UNetParams"]
    dd = vq["ddconfig"]
    P, ops, meta = Params(), Ops(), torch.device("meta")
    x = torch.empty(1, dd["in_channels"], dd["resolution"], dd["resolution"], device=meta)
    z = vq_encode(P, ops, x, vq)
    vq_quantize(P, z, vq)
    vq_decode(P, ops, z, vq)
    unet(P, ops, torch.empty(1, u["in_channels"], u["image_size"], u["image_size"], device=meta),
         torch.zeros(1, dtype=torch.long, device=meta), u)
    return P.specs

