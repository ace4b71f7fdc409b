"""Analytic FLOPs of the work a cell asks for (multiply-accumulate = 2 FLOPs;
conv = 2 * H*W * Cin * Cout * k^2; attention = its projections + 2 * T^2 * C
for the two matmuls), from the configuration's dicts. A frozen copy of the
arithmetic of the measured program's FLOP counter as it stood when this
benchmark was defined; ``mfu.*`` divide these by the window."""

from __future__ import annotations


def _conv(r, cin, cout, k=3):
    return 2.0 * r * r * cin * cout * k * k


def _resblock(r, cin, cout, time_dim):
    f = _conv(r, cin, cout) + 2.0 * time_dim * 2 * cout + _conv(r, cout, cout)
    if cin != cout:
        f += _conv(r, cin, cout, 1)
    return f


def _attention(r, ch):
    T = r * r
    return 2.0 * T * ch * 3 * ch + 2.0 * T * ch * ch + 2.0 * 2.0 * T * T * ch


def unet_forward(u) -> float:
    """One image through the UNet once."""
    mc, mults, nrb = u["model_channels"], tuple(u["channel_mult"]), u["num_res_blocks"]
    attn, r, tdim = tuple(u["attention_resolutions"]), u["image_size"], 4 * u["model_channels"]
    f = _conv(r, u["in_channels"], mc)
    ch, ds, skips = mc, 1, [mc]
    for level, mult in enumerate(mults):
        for _ in range(nrb):
            f += _resblock(r, ch, mult * mc, tdim)
            ch = mult * mc
            if ds in attn:
                f += _attention(r, ch)
            skips.append(ch)
        if level != len(mults) - 1:
            f += _resblock(r, ch, ch, tdim)
            r //= 2
            ds *= 2
            skips.append(ch)
    f += 2 * _resblock(r, ch, ch, tdim) + _attention(r, ch)
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            f += _resblock(r, ch + skips.pop(), mult * mc, tdim)
            ch = mult * mc
            if ds in attn:
                f += _attention(r, ch)
            if level and i == nrb:
                f += _resblock(r, ch, ch, tdim)
                r *= 2
                ds //= 2
    return f + _conv(r, ch, u["out_channels"])


def vqgan(vq, *, encode=True, decode=True) -> float:
    """One image through the VQGAN's encoder and/or decoder."""
    dd = vq["ddconfig"]
    ch, mults, nrb = dd["ch"], tuple(dd["ch_mult"]), dd["num_res_blocks"]
    attn_res = tuple(dd["attn_resolutions"])
    search = lambda r: 2.0 * r * r * vq["n_embed"] * vq["embed_dim"]

    def res(r, cin, cout):
        f = _conv(r, cin, cout) + _conv(r, cout, cout)
        return f + (_conv(r, cin, cout, 1) if cin != cout else 0.0)

    total = 0.0
    if encode:
        r = dd["resolution"]
        f, cin = _conv(r, dd["in_channels"], ch), ch
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
        f += _conv(r, cin, dd["z_channels"])
        f += _conv(r, dd["z_channels"], vq["embed_dim"], 1)
        f += search(r)
        total += f
    if decode:
        r = dd["resolution"] // 2 ** (len(mults) - 1)
        cmid = ch * mults[-1]
        f = _conv(r, vq["embed_dim"], dd["z_channels"], 1)
        f += search(r)
        f += _conv(r, dd["z_channels"], cmid)
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
        total += f + _conv(r, cin, dd["out_ch"])
    return total


def sample_batch(model_cfg, batch: int, draws: int) -> float:
    """One sample_to_eval batch: one encode per condition, then per draw the
    sampler's UNet forwards (one per grid step, euler) and one decode."""
    bb, vq = model_cfg["BB"]["params"], model_cfg["VQGAN"]["params"]
    steps = bb["sample_step"] if bb["skip_sample"] else bb["num_timesteps"]
    per_draw = steps * unet_forward(bb["UNetParams"]) + vqgan(vq, encode=False)
    return batch * (vqgan(vq, decode=False) + draws * per_draw)


def train_image(model_cfg) -> float:
    """One training image: the UNet forward and backward (3x the forward) and
    the two frozen encodes of image and condition."""
    return (3.0 * unet_forward(model_cfg["BB"]["params"]["UNetParams"])
            + 2.0 * vqgan(model_cfg["VQGAN"]["params"], decode=False))
