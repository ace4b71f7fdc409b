"""The ``sample_to_eval`` entry for the cross-attention LBBDM
(``reference/xattn.py``): ``entries/sample_to_eval.py`` as it stands, run
with the pieces that read the templates' reference replaced by this model's:
the parameter specs the runner's weights are drawn for, the FLOP count, the
kernel-call walk (``xattn_counts.py``, under the attention rule the measured
program has) and :func:`judge`, whose reference feeds the SpatialRescaler
context to every reverse step. The traffic, the
closed loop, the kept latents and the checked numbers are that entry's,
but for one thing: in a traced run the loop also hands over every batch up
to the traced one (``trace_batch``) after ``--seconds`` have passed, so that
a program whose batches outlast the window still has its traced batch (an
untraced run's loop is that entry's as it is).

The window also reads the program's attention route counters
(``bbdm_tpu_torch.ops.attention.ROUTES``: calls and FLOPs served by the
flash-attention kernel or the plain path) before and after, into
``obs["attention_routes"]``; a program without them leaves it None.
"""

from __future__ import annotations

import contextlib
import copy
import time
import types

import numpy as np
import torch

from benchmark import xattn_counts
from benchmark.entries import sample_to_eval as E
from benchmark.entries.common import weight_seed
from benchmark.reference import model as R
from benchmark.reference import xattn as X
from benchmark.weights import make_weights


def build_runner(config: dict, traffic: dict, seed: int, device):
    """``common.build_runner`` with this model's parameter specs."""
    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    cfg = copy.deepcopy({k: v for k, v in config.items() if k not in ("source", "assumed")})
    cfg["data"]["test"]["batch_size"] = traffic["batch"]
    cfg["data"]["train"]["batch_size"] = traffic["batch"]
    cfg["testing"]["sample_num"] = traffic.get("sample_num", 1)
    cfg["training"]["accumulate_grad_batches"] = traffic.get("accumulate", 1)
    runner = BBDMRunner(dict2namespace(cfg), device=device, seed=seed % (1 << 63))
    specs = X.param_specs(cfg["model"])
    weights = make_weights(specs, weight_seed(seed), device)
    runner.model.load_state_dict(weights, strict=True)
    del weights
    return runner, cfg, specs


@torch.no_grad()
def judge(P, model_cfg, x_cond, noise, z_prog, png_prog) -> dict:
    """``sample_to_eval.judge`` with this model's reference: its encode,
    context and reverse steps against the program's latents ``z_prog``, and
    its quantize and decode of ``z_prog`` against ``png_prog``."""
    ops, vq = R.Ops(), model_cfg["VQGAN"]["params"]
    y = R.vq_encode(P, ops, x_cond, vq)
    z_ref = X.sample_latent(P, ops, y, X.context(P, ops, x_cond, model_cfg), noise, model_cfg)
    lat_err = ((z_prog - z_ref).flatten(1).norm(dim=1) / z_ref.flatten(1).norm(dim=1)).max()
    img = R.vq_decode(P, ops, R.vq_quantize(P, z_prog, vq), vq).permute(0, 2, 3, 1).cpu().numpy()
    levels = max(float(np.abs(np.asarray(p, float) - E.to_uint8(i)).mean())
                 for p, i in zip(png_prog, img))
    return {"latent_rel_err": float(lat_err), "png_mean_levels": levels}


class Loader(E.Loader):
    """``sample_to_eval.Loader``, which also hands over batches ``0 ..
    last`` whatever the time."""

    def __init__(self, pool, seconds, last):
        super().__init__(pool, seconds)
        self.last = last

    def __iter__(self):
        i = 0
        while time.perf_counter() - self.opened < self.seconds or i <= self.last:
            yield E.pool_batch(self.pool, i)
            i += 1


@contextlib.contextmanager
def _this_model(ctx):
    """``sample_to_eval``'s module-level readers of the reference, swapped,
    and its loop swapped for :class:`Loader` up to the traced batch."""
    small_heads = xattn_counts.program_takes_small_heads()
    last = ctx["traffic"]["trace_batch"] if ctx["trace"] else -1
    swap = dict(build_runner=build_runner, judge=judge,
                Loader=lambda pool, seconds: Loader(pool, seconds, last),
                kernel_calls=lambda cfg, batch: xattn_counts.kernel_calls(cfg, batch, small_heads),
                flops=types.SimpleNamespace(sample_batch=xattn_counts.sample_batch))
    saved = {k: getattr(E, k) for k in swap}
    for k, v in swap.items():
        setattr(E, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(E, k, v)


def attention_routes():
    """{route: [calls, flops]} of the program's attention dispatch, or None."""
    try:
        from bbdm_tpu_torch.ops.attention import ROUTES
    except ImportError:
        return None
    return {name: [t.calls, t.flops] for name, t in ROUTES.items()}


def setup(ctx):
    with _this_model(ctx):
        return E.setup(ctx)


def window(st, ctx):
    before = attention_routes()
    with _this_model(ctx):
        obs = E.window(st, ctx)
    after = attention_routes()
    obs["attention_routes"] = None if before is None else {
        name: [b - a for a, b in zip(before[name], after[name])] for name in before}
    return obs


def check(st, obs, ctx, limits):
    with _this_model(ctx):
        return E.check(st, obs, ctx, limits)
