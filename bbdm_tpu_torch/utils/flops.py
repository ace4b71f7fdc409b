"""Analytic FLOP counts for the BBDM model families (port of
``bbdm_tpu/utils/flops.py``: the same four functions, the same arithmetic in
the same order, read from the port's ``ConfigNode``).

Closed-form counts (multiply-accumulate = 2 FLOPs; conv = 2 * H*W * Cin *
Cout * k^2; attention = qkv/proj projections + 2 * T^2 * C for the two
matmuls): the denominators of ``tools/bench.py``'s and ``tools/bench_train.py``'s
achieved TFLOP/s and ``mfu``.
"""

from __future__ import annotations


def _conv(r: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * r * r * cin * cout * k * k


def _resblock(r: int, cin: int, cout: int, time_dim: int) -> float:
    f = _conv(r, cin, cout)  # in_conv
    f += 2.0 * time_dim * 2 * cout  # emb projection (scale-shift worst case)
    f += _conv(r, cout, cout)  # out_conv
    if cin != cout:
        f += _conv(r, cin, cout, 1)  # skip 1x1
    return f


def _attention(r: int, ch: int) -> float:
    T = r * r
    f = 2.0 * T * ch * 3 * ch  # qkv
    f += 2.0 * T * ch * ch  # proj
    f += 2.0 * 2.0 * T * T * ch  # scores + weighted sum
    return f


def unet_forward_flops(unet_params) -> float:
    """Per-image forward FLOPs replaying the UNet layout (``models/unet.py``)."""
    p = unet_params
    mc = p.model_channels
    mults = tuple(p.channel_mult)
    nrb = p.num_res_blocks
    attn = tuple(p.attention_resolutions)
    r = p.image_size
    tdim = 4 * mc

    f = _conv(r, p.in_channels, mc)  # stem
    ch = mc
    ds = 1
    skips = [ch]
    for level, mult in enumerate(mults):
        for _ in range(nrb):
            f += _resblock(r, ch, mult * mc, tdim)
            ch = mult * mc
            if ds in attn:
                f += _attention(r, ch)
            skips.append(ch)
        if level != len(mults) - 1:
            f += _resblock(r, ch, ch, tdim)  # downsampling resblock (conv cost ~same)
            r //= 2
            ds *= 2
            skips.append(ch)
    # middle
    f += 2 * _resblock(r, ch, ch, tdim) + _attention(r, ch)
    # decoder
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            ich = skips.pop()
            f += _resblock(r, ch + ich, mult * mc, tdim)
            ch = mult * mc
            if ds in attn:
                f += _attention(r, ch)
            if level and i == nrb:
                f += _resblock(r, ch, ch, tdim)
                r *= 2
                ds //= 2
    f += _conv(r, ch, p.out_channels)  # head
    return f


def vqgan_flops(vq_params, *, encode: bool = True, decode: bool = True) -> float:
    """Per-image encoder/decoder FLOPs for the VQGAN (``models/vqgan.py``)."""
    dd = vq_params.ddconfig
    ch = dd.ch
    mults = tuple(dd.ch_mult)
    nrb = dd.num_res_blocks
    attn_res = tuple(dd.attn_resolutions)
    total = 0.0

    def res(r, cin, cout):
        f = _conv(r, cin, cout) + _conv(r, cout, cout)
        if cin != cout:
            f += _conv(r, cin, cout, 1)
        return f

    if encode:
        r = dd.resolution
        f = _conv(r, dd.in_channels, ch)
        cin = ch
        for i, m in enumerate(mults):
            cout = ch * m
            for j in range(nrb):
                f += res(r, cin if j == 0 else cout, cout)
                if r in attn_res:
                    f += _attention(r, cout)
            cin = cout
            if i != len(mults) - 1:
                f += _conv(r // 2, cin, cin)
                r //= 2
        f += 2 * res(r, cin, cin) + _attention(r, cin)
        f += _conv(r, cin, dd.z_channels)
        f += _conv(r, dd.z_channels, vq_params.embed_dim, 1)  # quant_conv
        # nearest-neighbour codebook search: 2 * T * n_embed * e_dim
        f += 2.0 * r * r * vq_params.n_embed * vq_params.embed_dim
        total += f
    if decode:
        r = dd.resolution // 2 ** (len(mults) - 1)
        cmid = ch * mults[-1]
        f = _conv(r, vq_params.embed_dim, dd.z_channels, 1)  # post_quant_conv
        f += 2.0 * r * r * vq_params.n_embed * vq_params.embed_dim  # quantize on decode path
        f += _conv(r, dd.z_channels, cmid)
        f += 2 * res(r, cmid, cmid) + _attention(r, cmid)
        cin = cmid
        for i in reversed(range(len(mults))):
            cout = ch * mults[i]
            for j in range(nrb + 1):
                f += res(r, cin if j == 0 else cout, cout)
                if r in attn_res:
                    f += _attention(r, cout)
            cin = cout
            if i != 0:
                r *= 2
                f += _conv(r, cin, cin)
        f += _conv(r, cin, dd.out_ch)
        total += f
    return total


def training_flops_per_image(model_config) -> float:
    """FLOPs to train on one example: UNet forward + backward on the latent
    (backward ~= 2x forward, the standard accounting) plus, for LBBDM, the
    two frozen first-stage ENCODES of image and condition (forward-only: no
    gradient flows into the frozen VQGAN — reference
    `model/BrownianBridge/LatentBrownianBridgeModel.py:33-44`). Optimizer /
    EMA / accumulator updates are bandwidth-bound elementwise passes with
    negligible FLOPs and are excluded on both sides of any comparison."""
    bb = model_config.BB.params
    f = 3.0 * unet_forward_flops(bb.UNetParams)
    if model_config.model_type == "LBBDM":
        f += 2.0 * vqgan_flops(model_config.VQGAN.params, decode=False)
    return f


def sampling_flops_per_image(model_config) -> float:
    """Total FLOPs to draw one sample (NFE UNet evals + VQGAN encode/decode).

    NFE: one eval per grid step for the reference/euler sampler; the heun
    sampler (``models/bridge.py``) runs two evals per non-terminal step plus the
    terminal one, 2(S-1)+1.
    """
    bb = model_config.BB.params
    steps = bb.sample_step if bb.skip_sample else bb.num_timesteps
    nfe = 2 * (steps - 1) + 1 if bb.get("sampler", "euler") == "heun" else steps
    f = nfe * unet_forward_flops(bb.UNetParams)
    if model_config.model_type == "LBBDM":
        f += vqgan_flops(model_config.VQGAN.params)
    return f
