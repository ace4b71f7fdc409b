"""The ``sample_to_eval`` entry: ``BBDMRunner.sample_to_eval`` over a closed
loop of test batches, as ``main_torch.py --sample_to_eval`` drives it.

The traffic file gives ``batch`` (conditions per batch), ``sample_num``
(draws per condition), ``pool_batches``, ``check_batches`` and the traced
batch and draws. The test loader is the benchmark's own iterable over a pool
of ``pool_batches`` host batches made from the seed in set-up: batch ``i``
holds pool batch ``i % pool_batches`` under names of its own, so that the
window does no work of the benchmark's on the host, and no batch starts once
``--seconds`` have passed. Each batch's noise, one sequence per draw, is
drawn on the card from the seed just before the batch and handed to the
model through the runner's ``noise=`` keyword, so the reference gets the
same noise without following the program's own draw order.

The window closes when ``sample_to_eval`` returns, its PNG writer drained.
The benchmark keeps, for two rows of every batch (one in each half, chosen by
the seed), the latent that each draw hands to the decoder. After the window
the reference, in float32, re-runs ``check_batches`` batches chosen by the
seed (one draw of each, chosen by the seed) on those rows: the encode, every
reverse step and the decode. Numbers compared:

* ``missing_pngs``: PNGs the window should have written and did not;
* ``input_png_levels``: the largest difference, in levels, of a condition or
  ground-truth PNG from the input image it was written from;
* ``latent_rel_err``: the largest ``|z - z_ref| / |z_ref|`` of a checked
  draw's latent against the reference's own encode and 200 steps;
* ``png_mean_levels``: the largest mean absolute difference, in levels, of a
  checked output PNG from the reference's quantize and decode of that draw's
  latent (the decode is judged from the program's latent, which the latent
  check holds against the reference's own).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import flops, traffic as T
from benchmark.entries.common import Profiler, build_runner, reference_weights, release
from benchmark.pngread import read_png
from benchmark.reference import model as R
from benchmark.trace import Spans
from benchmark.roofline import kernel_calls, scaled


def to_uint8(img):
    """The saved PNG's levels of a float image in [-1, 1] (round half up)."""
    img = np.clip(np.asarray(img, np.float32) * 0.5 + 0.5, 0.0, 1.0)
    return np.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def _rows(seed, batch):
    rng = np.random.RandomState(T.pair_seed(seed, 0x524f5753))
    half = batch // 2
    return [int(rng.randint(0, half)), int(half + rng.randint(0, batch - half))]


def make_pool(seed, traffic, size):
    return [T.host_batch(seed, j, traffic["batch"], size) for j in range(traffic["pool_batches"])]


def pool_batch(pool, i):
    """Batch ``i`` of the loop: pool batch ``i % len(pool)`` under batch ``i``'s names."""
    hb = pool[i % len(pool)]
    names = [f"b{i:05d}_{r:03d}" for r in range(len(hb["x_name"]))]
    return dict(hb, x_name=names, x_cond_name=names)


def plan(seed, batches, traffic):
    """The checked rows (one in each half of a batch), and the batches and
    their draws that the seed chooses among ``batches`` done."""
    rng = np.random.RandomState(T.pair_seed(seed, 0x43484b))
    chosen = sorted(rng.choice(batches, size=min(traffic["check_batches"], batches),
                               replace=False))
    return _rows(seed, traffic["batch"]), [int(b) for b in chosen], \
        [int(rng.randint(traffic["sample_num"])) for _ in chosen]


def checked_inputs(pool, seed, rows, chosen, draws, noise_shape, device):
    """(conditions [images, 3, H, W], noise [steps, images, ...], names) of
    the checked draws, in the order :func:`judge` takes them."""
    x_cond, noise, names = [], [], []
    for b, d in zip(chosen, draws):
        hb = pool_batch(pool, b)
        z = T.noise(seed, b, noise_shape, device)
        for r in rows:
            x_cond.append(torch.from_numpy(hb["x_cond"][r]).permute(2, 0, 1))
            noise.append(z[d, :, r])
            names.append(hb["x_name"][r])
        del z
    return torch.stack(x_cond).to(device), torch.stack(noise, dim=1), names


@torch.no_grad()
def judge(P, model_cfg, x_cond, noise, z_prog, png_prog) -> dict:
    """The float32 reference's readings of what a program produced for the
    conditions ``x_cond`` with ``noise``: its latents ``z_prog`` (the
    decoder's input, one a checked draw) against the reference's own encode
    and reverse steps, and its output images ``png_prog`` (uint8 HWC levels)
    against the reference's quantize and decode of ``z_prog``."""
    ops, vq = R.Ops(), model_cfg["VQGAN"]["params"]
    z_ref = R.sample_latent(P, ops, R.vq_encode(P, ops, x_cond, vq), noise, model_cfg)
    lat_err = ((z_prog - z_ref).flatten(1).norm(dim=1) / z_ref.flatten(1).norm(dim=1)).max()
    img = R.vq_decode(P, ops, R.vq_quantize(P, z_prog, vq), vq).permute(0, 2, 3, 1).cpu().numpy()
    levels = max(float(np.abs(np.asarray(p, float) - to_uint8(i)).mean())
                 for p, i in zip(png_prog, img))
    return {"latent_rel_err": float(lat_err), "png_mean_levels": levels}


def setup(ctx):
    tr, device, seed = ctx["traffic"], ctx["device"], ctx["seed"]
    runner, cfg, specs = build_runner(ctx["config"], tr, seed, device)
    model = runner.model
    spans = Spans()
    size = cfg["data"]["dataset_config"]["image_size"]
    st = dict(runner=runner, cfg=cfg, specs=specs, spans=spans, batch=0, draw=0, latents={},
              noise=None, rows=_rows(seed, tr["batch"]), prof=None, profile_draws=0,
              pool=make_pool(seed, tr, size))
    n, B = tr["sample_num"], tr["batch"]
    vq = cfg["model"]["VQGAN"]["params"]
    lat = vq["ddconfig"]["resolution"] // 2 ** (len(vq["ddconfig"]["ch_mult"]) - 1)
    st["latent_shape"] = (B, vq["embed_dim"], lat, lat)

    sample, encode, decode = runner._sample, model.encode, model.decode
    loop, batch_fn = model.p_sample_loop, runner.sample_batch

    def sample_with_noise(x_cond, **kw):
        draws = st["noise"]
        return sample(x_cond, noise=draws if n > 1 else draws[0], **kw)

    def encode_span(x, **kw):
        with spans("encode"):
            return encode(x, **kw)

    def decode_keeping(z, **kw):
        st["latents"][st["batch"], st["draw"]] = z[st["rows"]].float().clone()
        st["draw"] += 1
        with spans("decode"):
            out = decode(z, **kw)
        if st["prof"] is not None and st["draw"] >= st["profile_draws"]:
            st["prof"].stop()
            st["traced"], st["prof"] = st["prof"], None
        return out

    def loop_span(*a, **kw):
        with spans("p_sample_loop", sync=ctx["trace"] == 1):
            return loop(*a, **kw)

    def batch_span(x_cond):
        z = T.noise(seed, st["batch"], (n, model.noised_steps(), *st["latent_shape"]), device)
        st["noise"] = [list(z[d].unbind(0)) for d in range(n)]
        st["draw"] = 0
        traced = st["window"] and ctx["trace"] and st["batch"] == tr["trace_batch"]
        if traced:  # the whole batch is the profiled part: the profiler's start to its stop
            spans.begin_traced()
            st["prof"], st["profile_draws"] = Profiler(device), tr["trace_draws"]
            st["prof"].start()
        with spans("sample_batch"):
            out = batch_fn(x_cond)
        if traced:
            spans.end_traced()
        st["noise"] = None
        st["batch"] += 1
        return out

    runner._sample, model.encode, model.decode = sample_with_noise, encode_span, decode_keeping
    model.p_sample_loop, runner.sample_batch = loop_span, batch_span

    # warm-up: one batch through the whole path with the sampler cut to 3 steps
    coeffs = model.coeffs
    model.coeffs = type(coeffs)(**{k: v[:3] for k, v in vars(coeffs).items()})
    st["window"] = False
    runner.sample_to_eval([st["pool"][0]], os.path.join(ctx["scratch"], "warmup"))
    model.coeffs = coeffs
    st.update(batch=0, latents={}, window=True)
    spans.done.clear()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return st


class Loader:
    """The closed loop: batch ``i`` handed over when the runner asks, none after the deadline."""

    def __init__(self, pool, seconds):
        self.pool, self.seconds = pool, seconds
        self.opened = None

    def __iter__(self):
        i = 0
        while time.perf_counter() - self.opened < self.seconds:
            yield pool_batch(self.pool, i)
            i += 1


def window(st, ctx):
    tr, device = ctx["traffic"], ctx["device"]
    cfg = st["cfg"]
    out_dir = os.path.join(ctx["scratch"], "sample_to_eval")
    loader = Loader(st["pool"], ctx["seconds"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loader.opened = time.perf_counter()
    st["runner"].sample_to_eval(loader, out_dir)
    window_s = time.perf_counter() - loader.opened
    batches, B, n = st["batch"], tr["batch"], tr["sample_num"]
    steps = st["runner"].model.noised_steps()
    batch_flops = flops.sample_batch(cfg["model"], B, n)
    spans = st["spans"]
    obs = dict(window_s=window_s, batches=batches, images=batches * B * n, steps=steps,
               attempted=batches * B * n, out_dir=out_dir, spans=spans,
               flops=batches * batch_flops, untraced_s=window_s - spans.traced_s(),
               untraced_flops=(batches - len(spans.traced)) * batch_flops,
               peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    result = os.path.join(out_dir, str(cfg["model"]["BB"]["params"]["sample_step"]))
    missing = 0
    for i in range(batches):
        for r in range(B):
            name = f"b{i:05d}_{r:03d}"
            files = [os.path.join(out_dir, "condition", f"{name}.png"),
                     os.path.join(out_dir, "ground_truth", f"{name}.png")]
            files += ([os.path.join(result, name, f"output_{j}.png") for j in range(n)] if n > 1
                      else [os.path.join(result, f"{name}.png")])
            missing += sum(not os.path.exists(f) for f in files)
    obs["missing_pngs"] = missing
    obs["failed"] = missing
    if ctx["trace"]:
        if "traced" not in st:
            raise RuntimeError(f"the window ended before traced batch {tr['trace_batch']}")
        calls, draws = kernel_calls(cfg["model"], B), tr["trace_draws"]
        sliced = st.pop("traced").reduce()
        sliced["calls"] = (calls["encoder"] + scaled(calls["unet"], steps * draws)
                           + scaled(calls["decoder"], draws))
        sliced["elsize"] = 2 if cfg["model"].get("mixed_precision", True) else 4
        obs["trace"] = sliced
    return obs


def check(st, obs, ctx, limits):
    tr, device, seed = ctx["traffic"], ctx["device"], ctx["seed"]
    cfg, specs, latents, pool = st["cfg"], st["specs"], st["latents"], st["pool"]
    runner = st.pop("runner")
    steps = runner.model.noised_steps()
    del runner
    release()
    rows, chosen, draws = plan(seed, obs["batches"], tr)
    out_dir, n = obs["out_dir"], tr["sample_num"]
    result = os.path.join(out_dir, str(cfg["model"]["BB"]["params"]["sample_step"]))
    input_levels = 0
    for b in chosen:
        hb = pool_batch(pool, b)
        for r in rows:
            for kind, img in (("condition", hb["x_cond"][r]), ("ground_truth", hb["x"][r])):
                got = read_png(os.path.join(out_dir, kind, f"{hb['x_name'][r]}.png")).astype(int)
                input_levels = max(input_levels, int(np.abs(got - to_uint8(img)).max()))
    x_cond, noise, names = checked_inputs(pool, seed, rows, chosen, draws,
                                          (n, steps, *st["latent_shape"]), device)
    z_prog = torch.stack([latents[b, d][k] for b, d in zip(chosen, draws) for k in range(len(rows))])
    png_prog = [read_png(os.path.join(result, name, f"output_{d}.png") if n > 1
                         else os.path.join(result, f"{name}.png"))
                for name, d in zip(names, [d for d in draws for _ in rows])]
    got = judge(reference_weights(specs, seed, device), cfg["model"], x_cond, noise, z_prog,
                png_prog)
    return [("missing_pngs", obs["missing_pngs"], limits["missing_pngs"]),
            ("input_png_levels", input_levels, limits["input_png_levels"]),
            ("latent_rel_err", got["latent_rel_err"], limits["latent_rel_err"]),
            ("png_mean_levels", got["png_mean_levels"], limits["png_mean_levels"])]
