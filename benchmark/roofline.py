"""The least time each hand-written kernel could take for the calls a cell
makes, from shapes the benchmark finds itself.

The calls come from a walk of the plain reference (``reference/model.py``) on
the meta device with a recorder in place of its operations: every GroupNorm
is a ``group_norm`` call, every eval-mode nearest-2x up-conv an
``upsample_conv`` call, and every attention with at least ``ATTN_MIN_SEQ``
queries and a head width divisible by 128 a ``flash_attention`` call (the
measured program's dispatch rule for its attention kernel, frozen here).

A call's bound is the larger of its operations over the peak rate and its
bytes over the peak bandwidth (NVIDIA H100 SXM data sheet: 989 TFLOP/s dense
bf16, 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s), its bytes each
input read once and each output written once.
"""

from __future__ import annotations

from collections import Counter

import torch

from benchmark.reference import model as R

PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES_S = 989e12, 67e12, 3.35e12
ATTN_MIN_SEQ = 1024


class Recorder(R.Ops):
    """Records each call a kernel would serve and returns an empty result."""

    def __init__(self):
        self.calls = Counter()

    def group_norm(self, x, w, b, eps, silu=True, scale=None, shift=None):
        self.calls["group_norm", (*x.shape, scale is not None)] += 1
        return torch.empty_like(x)

    def upconv(self, x, w, b):
        N, ci, h, wd = x.shape
        self.calls["upsample_conv", (N, ci, h, wd, w.shape[0])] += 1
        return x.new_empty((N, w.shape[0], 2 * h, 2 * wd))

    def attention(self, q, k, v):
        if q.shape[-2] >= ATTN_MIN_SEQ and q.shape[-1] % 128 == 0:
            self.calls["flash_attention", (*q.shape, k.shape[-2])] += 1
        return torch.empty_like(q)


def kernel_calls(model_cfg, batch: int) -> dict:
    """{part: Counter of (kernel, key)} for one pass of each part at ``batch``:
    ``encoder`` (image -> latent), ``decoder`` (latent -> image) and ``unet``
    (one forward; in training mode its up-convs are plain convs, no kernel)."""
    vq, u = model_cfg["VQGAN"]["params"], model_cfg["BB"]["params"]["UNetParams"]
    dd, meta = vq["ddconfig"], torch.device("meta")
    P, out = R.Params(), {}
    lat = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
    z = torch.empty(batch, vq["embed_dim"], lat, lat, device=meta)
    for part, run in (
            ("encoder", lambda ops: R.vq_encode(P, ops, torch.empty(
                batch, dd["in_channels"], dd["resolution"], dd["resolution"], device=meta), vq)),
            ("decoder", lambda ops: R.vq_decode(P, ops, z, vq)),
            ("unet", lambda ops: R.unet(P, ops, torch.empty(
                batch, u["in_channels"], u["image_size"], u["image_size"], device=meta),
                torch.zeros(batch, dtype=torch.long, device=meta), u))):
        rec = Recorder()
        run(rec)
        out[part] = rec.calls
    return out


def scaled(calls: Counter, times: int) -> Counter:
    """``calls`` made ``times`` times over."""
    return Counter({k: n * times for k, n in calls.items()})


def bound_s(kernel: str, key: tuple, elsize: int) -> float:
    """The least seconds one call can take (``elsize``: bytes of an activation)."""
    if kernel == "group_norm":
        N, C, H, W, film = key
        numel = N * C * H * W
        flops, peak = 10 * numel, PEAK_FP32_FLOPS
        nbytes = 2 * numel * elsize + 8 * C + (2 * N * C * elsize if film else 0)
    elif kernel == "upsample_conv":
        n, ci, h, w, co = key
        flops, peak = 2 * n * h * w * 16 * ci * co, PEAK_BF16_FLOPS
        nbytes = elsize * (n * ci * h * w + 16 * ci * co + 4 * n * h * w * co) + 4 * co
    elif kernel == "flash_attention":
        B, H, T, D, Tk = key
        flops, peak = 4 * B * H * T * Tk * D, PEAK_BF16_FLOPS
        nbytes = (2 * B * H * T * D + 2 * B * H * Tk * D) * elsize
    else:
        raise ValueError(kernel)
    return max(flops / peak, nbytes / PEAK_BYTES_S)


def slice_bound_s(calls: Counter, kernel: str, elsize: int) -> float:
    """The bound of every call of ``kernel`` in ``calls`` (Counter of (kernel, key))."""
    return sum(n * bound_s(k, key, elsize) for (k, key), n in calls.items() if k == kernel)


def roofline_share(reduced: dict, kernel: str, patterns) -> float | None:
    """% of the bound of ``kernel``'s calls in the slice over the device time
    of the operations matching ``patterns``; None where none ran."""
    from benchmark.trace import kernel_s

    spent = kernel_s(reduced, patterns)
    if not spent:
        return None
    return 100.0 * slice_bound_s(reduced["calls"], kernel, reduced["elsize"]) / spent
