"""What the cross-attention LBBDM's cells count: its analytic FLOPs and the
calls its kernels serve, for ``reference/xattn.py``'s model.

FLOPs (multiply-accumulate = 2 FLOPs, as ``flops.py``): convs, the time MLP,
the ResBlocks' time projections, the transformers' projections, both
attention products (2 x 2 Tq Tk C a call over all heads) and the GEGLU
feed-forward; the nearest-2x up-conv at the output's resolution. Norms,
activations and the bridge's updates are left out, as torch's FLOP counter
leaves them out. The VQGAN's count is ``flops.vqgan``.

Kernel calls come from a walk of the reference on the meta device with
``roofline.Recorder``, whose attention rule is replaced by the measured
program's CUDA dispatch as this cell was defined: an attention goes to the
flash_attention kernel where Tq >= 1024 and D % 128 == 0, or, in bf16, where
Tq * Tk >= 2^20 and D is a multiple of 8 up to 256. A program from before
that rule (one without ``ops.attention.flash_route``) is walked under the
first half alone (``roofline.Recorder``'s rule), so that no roofline counts
calls its kernel did not serve.
"""

from __future__ import annotations

import torch

from benchmark import flops, roofline
from benchmark.reference import model as R
from benchmark.reference import xattn as X

MIN_SCORES = 1 << 20


def _transformer(r, ch, ctx_tokens, ctx_dim, depth) -> float:
    T = r * r
    f = 2 * (2.0 * T * ch * ch)  # proj_in, proj_out
    for _ in range(depth):
        f += 4 * 2.0 * T * ch * ch + 4.0 * T * T * ch  # self: q, k, v, out; QK^T, PV
        f += 2 * 2.0 * T * ch * ch + 2 * 2.0 * ctx_tokens * ctx_dim * ch  # cross: q, out; k, v
        f += 4.0 * T * ctx_tokens * ch
        f += 2.0 * T * ch * 8 * ch + 2.0 * T * 4 * ch * ch  # GEGLU proj, out
    return f


def _resblock(r, cin, cout, emb_ch) -> float:
    f = flops._conv(r, cin, cout) + 2.0 * emb_ch * cout + flops._conv(r, cout, cout)
    return f + (flops._conv(r, cin, cout, 1) if cin != cout else 0.0)


def unet_forward(model_cfg) -> float:
    """One image through the transformer UNet once."""
    u = model_cfg["BB"]["params"]["UNetParams"]
    mc, mults, nrb = u["model_channels"], tuple(u["channel_mult"]), u["num_res_blocks"]
    attn, r, emb_ch = tuple(u["attention_resolutions"]), u["image_size"], 4 * mc
    depth, ctx_dim = u.get("transformer_depth", 1), u["context_dim"]
    ctx_tokens = r * r
    tx = lambda res, c: _transformer(res, c, ctx_tokens, ctx_dim, depth)
    f = 2.0 * mc * emb_ch + 2.0 * emb_ch * emb_ch + flops._conv(r, u["in_channels"], mc)
    ch, ds, skips = mc, 1, [mc]
    for level, mult in enumerate(mults):
        for _ in range(nrb):
            f += _resblock(r, ch, mult * mc, emb_ch)
            ch = mult * mc
            if ds in attn:
                f += tx(r, ch)
            skips.append(ch)
        if level != len(mults) - 1:
            r //= 2
            f += flops._conv(r, ch, ch)
            ds *= 2
            skips.append(ch)
    f += 2 * _resblock(r, ch, ch, emb_ch) + tx(r, ch)
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            f += _resblock(r, ch + skips.pop(), mult * mc, emb_ch)
            ch = mult * mc
            if ds in attn:
                f += tx(r, ch)
            if level and i == nrb:
                r *= 2
                f += flops._conv(r, ch, ch)
                ds //= 2
    return f + flops._conv(r, ch, u["out_channels"])


def context_flops(model_cfg) -> float:
    """The SpatialRescaler's 1x1 channel_mapper, per image."""
    cp, u = model_cfg["CondStageParams"], model_cfg["BB"]["params"]["UNetParams"]
    if cp.get("out_channels") is None:
        return 0.0
    return flops._conv(u["image_size"], cp["in_channels"], cp["out_channels"], 1)


def sample_batch(model_cfg, batch: int, draws: int) -> float:
    """One sample_to_eval batch: one encode and one context per condition,
    then per draw the sampler's UNet forwards (one per grid step, euler) and
    one decode."""
    bb, vq = model_cfg["BB"]["params"], model_cfg["VQGAN"]["params"]
    steps = bb["sample_step"] if bb["skip_sample"] else bb["num_timesteps"]
    per_draw = steps * unet_forward(model_cfg) + flops.vqgan(vq, encode=False)
    return batch * (flops.vqgan(vq, decode=False) + context_flops(model_cfg) + draws * per_draw)


def program_takes_small_heads() -> bool:
    """Whether the measured program's dispatch has the rule for bf16 heads of
    8..256 (``bbdm_tpu_torch.ops.attention.flash_route``)."""
    try:
        from bbdm_tpu_torch.ops import attention
    except ImportError:
        return False
    return hasattr(attention, "flash_route")


class Recorder(roofline.Recorder):
    """``roofline.Recorder`` under the dispatch rule of this module's
    docstring; ``small_heads`` False keeps the first half alone."""

    def __init__(self, small_heads=True):
        super().__init__()
        self.small_heads = small_heads

    def attention(self, q, k, v):
        Tq, D, Tk = q.shape[-2], q.shape[-1], k.shape[-2]
        if (Tq >= roofline.ATTN_MIN_SEQ and D % 128 == 0) or \
                (self.small_heads and Tq * Tk >= MIN_SCORES and D % 8 == 0 and D <= 256):
            self.calls["flash_attention", (*q.shape, Tk)] += 1
        return torch.empty_like(q)


def kernel_calls(model_cfg, batch: int, small_heads=True) -> dict:
    """{part: Counter of (kernel, key)} for one pass of each part at ``batch``,
    as ``roofline.kernel_calls`` gives them: ``encoder`` (image -> latent, the
    context's resize and 1x1 conv), ``decoder`` and ``unet`` (one forward).
    ``small_heads``: the program has the rule for bf16 heads of 8..256 (it
    applies where the model runs in bf16)."""
    vq, u = model_cfg["VQGAN"]["params"], model_cfg["BB"]["params"]["UNetParams"]
    dd, meta = vq["ddconfig"], torch.device("meta")
    small_heads = small_heads and model_cfg.get("mixed_precision", True)
    P, out = R.Params(), {}
    x, t, ctx = X.unet_inputs(model_cfg, batch, meta)
    img = torch.empty(batch, dd["in_channels"], dd["resolution"], dd["resolution"], device=meta)
    for part, run in (
            ("encoder", lambda ops: (R.vq_encode(P, ops, img, vq),
                                     X.context(P, ops, img, model_cfg))),
            ("decoder", lambda ops: R.vq_decode(P, ops, x, vq)),
            ("unet", lambda ops: X.unet(P, ops, x, t, ctx, u))):
        rec = Recorder(small_heads)
        run(rec)
        out[part] = rec.calls
    return out
