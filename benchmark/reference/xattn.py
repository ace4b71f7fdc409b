"""A plain PyTorch cross-attention LBBDM: the Stable Diffusion v1 UNet
(``ldm.modules.diffusionmodules.openaimodel.UNetModel`` with
``use_spatial_transformer``, arXiv 2112.10752) as the denoiser of the BBDM
bridge, conditioned on a ``SpatialRescaler`` context that is both
concatenated to the UNet's input and attended to, in float32 with plain
operations.

The VQGAN, the schedule, the sampler's coefficients, the operations and the
weights come from ``reference/model.py``, whose conventions hold here: every
parameter is asked for through ``Params`` under the measured program's names
(``unet.down_0_0_attn.block_0.attn2.to_k.weight``, ...), and conv, linear,
group norm, the nearest-2x up-conv and attention go through an ``Ops``
object, so that the float8 control (``lowp.Fp8Ops``) and the kernel-call
walk take this model as they take the templates'.

Where the published code and the measured program differ, this reference
follows the program (the configuration's ``assumed`` lists each): the
feed-forward's GELU is the tanh form, LayerNorm's epsilon 1e-6, the
transformer's GroupNorm epsilon 1e-6; the UNet's time MLP runs in float32;
GroupNorm and LayerNorm statistics and the softmax are float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import model as R


# ------------------------------------------------------------- the context

def context(P, ops, x_cond, model_cfg):
    """The SpatialRescaler of the condition image [B, 3, H, W]: ``n_stages``
    bilinear resizes by ``multiplier`` (half-pixel centres, no antialias),
    then a bias-free 1x1 ``channel_mapper``."""
    cp = model_cfg["CondStageParams"]
    if cp.get("method", "bilinear") != "bilinear":
        raise NotImplementedError("the reference's SpatialRescaler is bilinear")
    x, m = x_cond, cp.get("multiplier", 0.5)
    for _ in range(cp.get("n_stages", 1)):
        H, W = x.shape[-2:]
        x = F.interpolate(x, size=(int(H * m), int(W * m)), mode="bilinear",
                          align_corners=False)
    if cp.get("out_channels") is None:
        return x
    w = P("cond_stage.channel_mapper.weight", (cp["out_channels"], cp["in_channels"], 1, 1),
          "conv")
    return ops.conv(x, w, None)


# ------------------------------------------------------------------- layers

def _res(P, ops, name, x, emb, cin, cout, emb_ch):
    """The ResBlock without FiLM: the time embedding added between the convs."""
    h = R._conv(P, ops, f"{name}.in_conv", R._norm(P, ops, f"{name}.in_norm", x, 1e-5),
                cin, cout, 3)
    h = h + R._dense(P, ops, f"{name}.emb_proj", F.silu(emb), emb_ch, cout)[:, :, None, None]
    h = R._conv(P, ops, f"{name}.out_conv", R._norm(P, ops, f"{name}.out_norm", h, 1e-5),
                cout, cout, 3)
    if cin != cout:
        x = R._conv(P, ops, f"{name}.skip", x, cin, cout, 1)
    return x + h


def _layer_norm(P, name, x):
    C = x.shape[-1]
    return F.layer_norm(x, (C,), P(f"{name}.weight", (C,), "norm_w"),
                        P(f"{name}.bias", (C,), "norm_b"), eps=1e-6)


def _linear(P, ops, name, x, fin, fout, bias=True):
    w = P(f"{name}.weight", (fout, fin), "dense")
    return ops.linear(x, w, P(f"{name}.bias", (fout,), "bias") if bias else None)


def _cross_attention(P, ops, name, x, ctx, heads, dim_head, ctx_dim):
    """Attention of x's tokens [B, T, C] over ``ctx``'s [B, Tk, ctx_dim]."""
    B, T, C = x.shape
    inner = heads * dim_head

    def split(t):
        return t.reshape(B, t.shape[1], heads, dim_head).transpose(1, 2)

    q = split(_linear(P, ops, f"{name}.to_q", x, C, inner, bias=False))
    k = split(_linear(P, ops, f"{name}.to_k", ctx, ctx_dim, inner, bias=False))
    v = split(_linear(P, ops, f"{name}.to_v", ctx, ctx_dim, inner, bias=False))
    a = ops.attention(q, k, v).transpose(1, 2).reshape(B, T, inner)
    return _linear(P, ops, f"{name}.to_out", a, inner, C)


def _transformer(P, ops, name, x, ctx_tokens, heads, ctx_dim, depth):
    """GroupNorm -> 1x1 proj_in -> ``depth`` blocks of self-attention,
    cross-attention to the context's tokens and a GEGLU feed-forward, each
    after a LayerNorm and added to its input -> 1x1 proj_out, added to x."""
    B, C, H, W = x.shape
    dim_head = C // heads
    h = R._norm(P, ops, f"{name}.norm", x, 1e-6, silu=False)
    h = R._conv(P, ops, f"{name}.proj_in", h, C, C, 1).flatten(2).transpose(1, 2)
    for d in range(depth):
        b = f"{name}.block_{d}"
        n1 = _layer_norm(P, f"{b}.norm1", h)
        h = _cross_attention(P, ops, f"{b}.attn1", n1, n1, heads, dim_head, C) + h
        h = _cross_attention(P, ops, f"{b}.attn2", _layer_norm(P, f"{b}.norm2", h), ctx_tokens,
                             heads, dim_head, ctx_dim) + h
        val, gate = _linear(P, ops, f"{b}.ff.proj", _layer_norm(P, f"{b}.norm3", h), C,
                            8 * C).chunk(2, dim=-1)
        h = _linear(P, ops, f"{b}.ff.out", val * F.gelu(gate, approximate="tanh"), 4 * C, C) + h
    h = h.transpose(1, 2).reshape(B, C, H, W)
    return x + R._conv(P, ops, f"{name}.proj_out", h, C, C, 1)


# --------------------------------------------------------------------- UNet

def unet(P, ops, x, t, ctx, u):
    """The transformer UNet: ResBlocks without FiLM, stride-2 conv
    ``Downsample`` and nearest + conv ``Upsample``, a ``SpatialTransformer``
    after each ResBlock of a level whose factor is in
    ``attention_resolutions`` and in the middle; the context concatenated to
    x and attended to by every transformer."""
    if u["use_scale_shift_norm"] or u["resblock_updown"] or not u["use_spatial_transformer"] \
            or u["condition_key"] == "nocond" or u["num_head_channels"] != -1:
        raise NotImplementedError("the reference's transformer UNet has no FiLM, conv "
                                  "resampling, a context and num_heads heads")
    mc, mults, nrb = u["model_channels"], tuple(u["channel_mult"]), u["num_res_blocks"]
    attn_res, emb_ch, heads = tuple(u["attention_resolutions"]), 4 * mc, u["num_heads"]
    depth, ctx_dim = u.get("transformer_depth", 1), u["context_dim"]
    ctx_tokens = ctx.flatten(2).transpose(1, 2)

    def attend(name, h):
        return _transformer(P, ops, name, h, ctx_tokens, heads, ctx_dim, depth)

    emb = R._dense(P, ops, "unet.time_dense_0", R.timestep_embedding(t, mc), mc, emb_ch)
    emb = R._dense(P, ops, "unet.time_dense_1", F.silu(emb), emb_ch, emb_ch)
    x = torch.cat([x, ctx], dim=1)
    h = R._conv(P, ops, "unet.stem", x, u["in_channels"], mc, 3)
    hs, ch, ds = [h], mc, 1
    for lvl, m in enumerate(mults):
        for i in range(nrb):
            h = _res(P, ops, f"unet.down_{lvl}_{i}", h, emb, ch, m * mc, emb_ch)
            ch = m * mc
            if ds in attn_res:
                h = attend(f"unet.down_{lvl}_{i}_attn", h)
            hs.append(h)
        if lvl != len(mults) - 1:
            h = R._conv(P, ops, f"unet.down_{lvl}_ds.op", h, ch, ch, 3, stride=2)
            hs.append(h)
            ds *= 2
    h = _res(P, ops, "unet.mid_res_0", h, emb, ch, ch, emb_ch)
    h = attend("unet.mid_attn", h)
    h = _res(P, ops, "unet.mid_res_1", h, emb, ch, ch, emb_ch)
    for lvl, m in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            skip = hs.pop()
            h = _res(P, ops, f"unet.up_{lvl}_{i}", torch.cat([h, skip], dim=1), emb,
                     ch + skip.shape[1], m * mc, emb_ch)
            ch = m * mc
            if ds in attn_res:
                h = attend(f"unet.up_{lvl}_{i}_attn", h)
            if lvl and i == nrb:
                h = R._upconv(P, ops, f"unet.up_{lvl}_us.conv", h, ch, ch)
                ds //= 2
    h = R._norm(P, ops, "unet.out_norm", h, 1e-5)
    return R._conv(P, ops, "unet.out_conv", h.float(), ch, u["out_channels"], 3)


# ---------------------------------------------------------------- the bridge

def sample_latent(P, ops, y, ctx, noise, model_cfg):
    """The reverse bridge from x_T = y, the context fed to every UNet forward:
    one forward and one update per step, ``noise[i]`` the step's noise."""
    bb = model_cfg["BB"]["params"]
    R.check_objective(bb)
    x = y
    for i, (t, a_xt, a_x0, a_y, sigma) in enumerate(R.sampler_coeffs(bb)):
        tt = torch.full((y.shape[0],), t, dtype=torch.long, device=y.device)
        x0 = x - unet(P, ops, x, tt, ctx, bb["UNetParams"]).float()
        x = a_xt * x + a_x0 * x0 + a_y * y
        if sigma:
            x = x + sigma * noise[i]
    return x


def unet_inputs(model_cfg, batch, device):
    """(x, t, context) of the UNet's shapes at ``batch``, empty, on ``device``."""
    vq, u = model_cfg["VQGAN"]["params"], model_cfg["BB"]["params"]["UNetParams"]
    dd = vq["ddconfig"]
    lat = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
    ctx_ch = model_cfg["CondStageParams"].get("out_channels") or \
        model_cfg["CondStageParams"]["in_channels"]
    return (torch.empty(batch, vq["embed_dim"], lat, lat, device=device),
            torch.zeros(batch, dtype=torch.long, device=device),
            torch.empty(batch, ctx_ch, lat, lat, device=device))


def param_specs(model_cfg) -> dict:
    """{name: (shape, kind)} of every weight, in the order a forward pass asks for them."""
    vq = model_cfg["VQGAN"]["params"]
    dd = vq["ddconfig"]
    P, ops, meta = R.Params(), R.Ops(), torch.device("meta")
    img = torch.empty(1, dd["in_channels"], dd["resolution"], dd["resolution"], device=meta)
    z = R.vq_encode(P, ops, img, vq)
    R.vq_quantize(P, z, vq)
    R.vq_decode(P, ops, z, vq)
    ctx = context(P, ops, img, model_cfg)
    x, t, _ = unet_inputs(model_cfg, 1, meta)
    unet(P, ops, x, t, ctx, model_cfg["BB"]["params"]["UNetParams"])
    return P.specs
