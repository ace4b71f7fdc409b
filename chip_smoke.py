#!/usr/bin/env python3
"""Drive the PyTorch port (``bbdm_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which must pass:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, TF32 off;
2. kernel build: nvcc of ``bbdm_tpu_torch/csrc/*.cu`` for sm_90a;
3. each hand-written kernel (K1 GroupNorm, K2 subpixel up-conv, K3 flash
   attention, all CUDA C++) against its plain PyTorch twin on the card at the
   shapes the LBBDM-f4 path gives it and at edge cases, one launch per call;
   at the path shapes also CUDA-event times of the kernel (wrapper included),
   its twin and one PyTorch library call computing the same function (or, for
   K1, a subset of it), the kernel's own device time from torch.profiler, and
   its bound: the larger of its bytes over 3.35 TB/s and its operations over
   the peak rate for their type (H100 SXM data sheet);
4. the LBBDM-f4 slice at full width (VQGAN ch 128 x (1,2,4) at 256^2, UNet
   mc 128 x (1,4,8) at 64^2, bf16, batch 8, seeded random weights), cut to
   20 sampling steps and 2 draws per condition: the sampled latent through
   the kernels against the same run forced through the plain twins (same
   weights, same noise), then ``BBDMRunner.sample_to_eval`` over synthetic
   batches into a temporary directory, with every kernel's launch count;
5. the CLI, ``main_torch.main``, on synthetic ``custom_aligned`` PNG datasets
   (16 test pairs, 256^2 for LBBDM-f4, 64^2 for pixel BBDM) with text copies
   of ``configs/Template-{LBBDM-f4,BBDM}.yaml`` (cut to 20 steps) and model
   checkpoints whose ``model`` and ``ema`` weights differ, at full width:
   LBBDM-f4 euler ``--sample_to_eval`` (2 draws), LBBDM-f4 heun
   ``--sample_to_eval``, BBDM grid mode and BBDM ``--sample_to_eval``, each
   with its kernels' launch counts and output tree; the euler run against an
   in-process ``BBDMRunner`` given the same EMA weights and seed; heun through
   the kernels against heun through the twins (same noise); the card's idle
   share over one CLI batch; the host's PNG decode time per 256^2 image.

Prints the kernels' JSON line, then as its last line
``{"ok": true, "device": {...}}``; exits non-zero, without that line, when a
phase fails, when there is no CUDA card, or when run outside a checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import torch

SAMPLE_STEP, SAMPLE_NUM, BATCHES, BATCH = 20, 2, 2, 8
CLI_TEST_PAIRS, CLI_SEED = 16, 1234


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, runs=10, warmup=2):
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(out, ref, rtol, atol):
    """(max abs error, max error relative to max |ref|, all within atol + rtol*|ref|)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    ok = bool(torch.isfinite(out).all() and (diff <= atol + rtol * ref.abs()).all())
    return float(diff.max()), float(diff.max() / ref.abs().max().clamp_min(1e-30)), ok


@contextlib.contextmanager
def plain_ops():
    """Route the port's three kernel-bearing ops to their plain twins for the
    length of the block (the package itself never sends a CUDA tensor there)."""
    from bbdm_tpu_torch.ops import attention, group_norm, upsample_conv

    saved = (group_norm.group_norm, upsample_conv.upsample2x_conv3x3,
             attention.multi_head_attention)
    group_norm.group_norm = group_norm.group_norm_plain
    upsample_conv.upsample2x_conv3x3 = (
        lambda x, w, b, *, dtype=None, combined=None:
        upsample_conv.upsample_conv_plain(x, w, b, dtype=dtype))
    attention.multi_head_attention = attention.attention_plain
    try:
        yield
    finally:
        (group_norm.group_norm, upsample_conv.upsample2x_conv3x3,
         attention.multi_head_attention) = saved


# ------------------------------------------------------------------ kernels

def upconv_transposed_kernel(w):
    """[co, ci, 3, 3] -> [ci, co, 4, 4] such that
    ``conv_transpose2d(x, W4, b, stride=2, padding=1)`` is exactly
    ``conv2d(interpolate(x, 2, 'nearest'), w, b, padding=1)``: along each axis
    output 2m reads x[m-1] w0 + x[m] (w1 + w2) and 2m+1 reads x[m] (w0 + w1) +
    x[m+1] w2, so the four transposed taps are (w2, w1 + w2, w0 + w1, w0)."""
    m = torch.tensor([[0, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0]], dtype=torch.float32,
                     device=w.device)
    return torch.einsum("ar,bs,oirs->ioab", m, m, w.float()).to(w.dtype)


def kernel_times_us(fn, calls=5):
    """{device kernel name: microseconds per call} of fn() from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def sdpa_backends(q, k, v):
    """CUDA-event ms of F.scaled_dot_product_attention at D^-1/2 with each backend
    pinned in turn, or why it refused."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([be]):
                warnings.simplefilter("ignore")
                out[be.name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=q.shape[-1] ** -0.5), runs=5)
        except RuntimeError as e:
            out[be.name] = "refused: " + str(e).strip().splitlines()[0][:120]
    return out


def kernel_cases(dev):
    """(name, route, source, replaces, counter, kernel-name fragment, cases); each
    case is (label, run_kernel, run_plain, rtol, atol, work): work None marks an
    edge case that is checked but not timed, else a dict with the case's
    ``flops`` at ``peak`` FLOP/s, its ``bytes`` (each input read once, each output
    written once) and its ``library`` call (or None)."""
    import torch.nn.functional as F

    from bbdm_tpu_torch.ops import (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, attention, group_norm,
                                    upsample_conv)

    g = torch.Generator(dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    gn = []
    # timed: UNet up_0_0.in_norm at 64^2 (C=640), UNet up_2_us.out_norm with FiLM
    # (C=1024 at 32^2), VQGAN decoder up_0_block_0.norm1 (C=256 at 256^2); then
    # the edge cases of the gpu-marked tests: a span that overflows a cluster of 8
    # (fp32 at 256^2), a ragged span (C=96 at 7x5), fp16 with FiLM, a cluster of
    # 4, and a ragged span split over a cluster of 2
    for shape, film, eps, dtype, timed in (
            ((BATCH, 640, 64, 64), False, 1e-5, torch.bfloat16, True),
            ((BATCH, 1024, 32, 32), True, 1e-5, torch.bfloat16, True),
            ((BATCH, 256, 256, 256), False, 1e-6, torch.bfloat16, True),
            ((1, 256, 256, 256), False, 1e-6, torch.float32, False),
            ((2, 96, 7, 5), False, 1e-5, torch.bfloat16, False),
            ((2, 320, 24, 24), True, 1e-5, torch.float16, False),
            ((2, 256, 128, 128), False, 1e-6, torch.bfloat16, False),
            ((2, 32, 255, 255), True, 1e-6, torch.bfloat16, False)):
        N, C, H, W = shape
        x = randn(*shape, scale=2.0, dtype=dtype)
        w, b = 1 + randn(C, scale=0.1, dtype=torch.float32), randn(C, scale=0.1,
                                                                   dtype=torch.float32)
        f = randn(N, 2 * C, scale=0.1, dtype=dtype) if film else None
        fs, fb = f.chunk(2, dim=1) if film else (None, None)
        kw = dict(eps=eps, act="silu", film_scale=fs, film_shift=fb)
        wl, bl = w.to(dtype), b.to(dtype)
        plan = group_norm.plan_group_norm(N, C, H * W, 32, x.element_size())
        work = dict(flops=10 * x.numel(), peak=PEAK_FP32_FLOPS,
                    bytes=group_norm.group_norm_bytes(x, w, fs),
                    library=lambda x=x, wl=wl, bl=bl, eps=eps: F.group_norm(x, 32, wl, bl, eps),
                    library_call="F.group_norm (no FiLM, no SiLU: a subset of K1's work)")
        clusters = group_norm._launch_shape(plan, group_norm._DTYPES[dtype], dev.index)[1]
        gn.append((f"{list(shape)} {str(dtype)[6:]} film={film} cs={plan.cs} "
                   f"clusters={clusters}"
                   f"{' overflow=' + str(plan.overflow) if plan.overflow else ''}"
                   f"{'' if plan.bulk else ' vector-loads'}",
                   lambda x=x, w=w, b=b, kw=kw: group_norm.group_norm(x, w, b, **kw),
                   lambda x=x, w=w, b=b, kw=kw: group_norm.group_norm_plain(x, w, b, **kw),
                   # fp32 arithmetic on both sides; 16-bit outputs may round up to 2
                   # ulps apart
                   *((1e-4, 1e-4) if dtype == torch.float32 else (2 ** -7, 2 ** -7)),
                   work if timed else None))

    up = []
    # UNet up_2_us / up_1_us in_conv, VQGAN decoder up_2_upsample / up_1_upsample; then
    # the edge cases of the gpu-marked tests (ragged co, ci < 64, w = 40, h = 24) and
    # one that pads every dimension (ci % 8, co < 128, h < one tile of rows, w % 4)
    for (n, ci, h, wd), co, timed in (((BATCH, 1024, 16, 16), 1024, True),
                                      ((BATCH, 512, 32, 32), 512, True),
                                      ((BATCH, 512, 64, 64), 512, True),
                                      ((BATCH, 256, 128, 128), 256, True),
                                      ((1, 32, 24, 40), 96, False),
                                      ((2, 64, 16, 16), 64, False),
                                      ((1, 20, 5, 7), 30, False)):
        x = randn(n, ci, h, wd)
        w = randn(co, ci, 3, 3, scale=0.02, dtype=torch.float32)
        b = randn(co, scale=0.1, dtype=torch.float32)
        kp = upsample_conv.combine_kernel_2x2(w).to(torch.bfloat16)
        w4, bl = upconv_transposed_kernel(w).to(torch.bfloat16), b.to(torch.bfloat16)
        work = dict(flops=2 * n * h * wd * 16 * ci * co, peak=PEAK_BF16_FLOPS,
                    bytes=2 * (x.numel() + kp.numel() + 4 * n * h * wd * co) + 4 * co,
                    library=lambda x=x, w4=w4, bl=bl: F.conv_transpose2d(
                        x, w4, bl, stride=2, padding=1),
                    library_call="F.conv_transpose2d(x, W4, b, stride=2, padding=1)")
        up.append((f"{[n, ci, h, wd]}->{co}",
                   lambda x=x, kp=kp, b=b: upsample_conv.upsample_conv_cuda(x, kp, b),
                   lambda x=x, w=w, b=b: upsample_conv.upsample_conv_plain(
                       x, w, b, dtype=torch.bfloat16),
                   # the kernel's phase taps are fp32 sums rounded to bf16 once, the
                   # twin's 3x3 taps are rounded one by one: 2^-8 relative per tap,
                   # plus one output rounding each
                   2 ** -5, 2 ** -5, work if timed else None))

    fa = []
    # VQGAN encoder / decoder mid_attn_1: H=1, T=64^2, D=512; then the edge cases of
    # the gpu-marked tests: ragged T (keys masked, rows not written) and D=128; then
    # T and D below one 64 x 64 box
    for shape, timed in (((BATCH, 1, 4096, 512), True), ((1, 2, 1100, 128), False),
                         ((2, 1, 1024, 512), False), ((1, 1, 50, 48), False)):
        q, k, v = (randn(*shape) for _ in range(3))
        B, H, T, D = shape
        work = dict(flops=4 * B * H * T * T * D, peak=PEAK_BF16_FLOPS, bytes=4 * q.numel() * 2,
                    library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                        q, k, v, scale=q.shape[-1] ** -0.5),
                    library_call="F.scaled_dot_product_attention(q, k, v, scale=D**-0.5)",
                    backends=lambda q=q, k=k, v=v: sdpa_backends(q, k, v))
        fa.append((f"{list(shape)}",
                   lambda q=q, k=k, v=v: attention.flash_attention_cuda(q, k, v),
                   lambda q=q, k=k, v=v: attention.attention_plain(q, k, v),
                   # the twin rounds q*D^-1/4 and k*D^-1/4 to bf16 (as _xla_attention
                   # does; the kernel scales the fp32 scores), and both round the
                   # probabilities to bf16: 2^-8 relative each, over T keys
                   2 ** -6, 2 ** -7, work if timed else None))

    return [
        ("group_norm", "cuda", "bbdm_tpu_torch/csrc/group_norm.cu",
         "bbdm_tpu/ops/group_norm_pallas.py:178", (group_norm, "group_norm_cuda"),
         "group_norm_kernel", gn),
        ("subpixel_upconv", "cuda", "bbdm_tpu_torch/csrc/subpixel_upconv.cu",
         "bbdm_tpu/ops/subpixel_pallas.py:133", (upsample_conv, "upsample_conv_cuda"),
         "subpixel_upconv_kernel", up),
        ("flash_attention", "cuda", "bbdm_tpu_torch/csrc/flash_attention.cu",
         "bbdm_tpu/ops/flash_attention.py:115", (attention, "flash_attention_cuda"),
         "flash_attention_kernel", fa),
    ]


def kernel_phase(name, counter, pattern, cases):
    """Check each case against the twin (and that it is one launch); time the
    path shapes; returns the kernel's JSON entry (sums over the timed shapes)."""
    from bbdm_tpu_torch.ops import PEAK_BYTES_S

    mod, attr = counter
    entry = {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
             "bound_ms": 0.0, "bound_by": None, "library_ms": 0.0, "shapes": []}
    ops_s = bytes_s = 0.0
    ok = True
    for label, run, plain, rtol, atol, work in cases:
        before = getattr(mod, attr).launches
        out = run()
        launched = getattr(mod, attr).launches - before
        ref = plain()
        torch.cuda.synchronize()
        abs_err, rel_err, good = compare(out, ref, rtol, atol)
        good &= launched == 1
        line = (f"  {name} {label}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
                f"(bar |d| <= {atol:g} + {rtol:g}|ref|), launches {launched} "
                f"{'ok' if good else 'FAIL'}")
        shape = {"shape": label, "max_abs_err": abs_err}
        if work is None:
            line += "; edge case, not timed"
        else:
            ms, plain_ms, lib_ms = cuda_ms(run), cuda_ms(plain), cuda_ms(work["library"])
            dev = sum(v for k, v in kernel_times_us(run).items() if pattern in k)
            t_ops, t_bytes = work["flops"] / work["peak"], work["bytes"] / PEAK_BYTES_S
            bound_us = max(t_ops, t_bytes) * 1e6
            ops_s, bytes_s = ops_s + t_ops, bytes_s + t_bytes
            shape.update(ms=ms, plain_ms=plain_ms, device_us=dev or None, bound_us=bound_us,
                         bound_by="operations" if t_ops > t_bytes else "bytes",
                         library_ms=lib_ms, library_call=work["library_call"])
            line += (f"; kernel {ms:.4f} ms (device {dev:.1f} us), plain {plain_ms:.4f} ms, "
                     f"library {lib_ms:.4f} ms; bound {bound_us:.1f} us "
                     f"({shape['bound_by']}), {bound_us / dev:.0%} of it" if dev else
                     "; device time not measured")
            if "backends" in work:
                shape["library_backends"] = work["backends"]()
                line += f"; sdpa backends {shape['library_backends']}"
            entry["ms"] += ms
            entry["plain_ms"] += plain_ms
            entry["library_ms"] += lib_ms
        log(line)
        entry["shapes"].append(shape)
        entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
        entry["max_rel_err"] = max(entry["max_rel_err"], rel_err)
        ok &= good
        del out, ref
    entry["bound_ms"] = max(ops_s, bytes_s) * 1e3
    entry["bound_by"] = "operations" if ops_s > bytes_s else "bytes"
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    return entry


# ------------------------------------------------------------------- slice

def slice_phase(dev, counters):
    import numpy as np

    from bbdm_tpu_torch.config import lbbdm_f4_config
    from bbdm_tpu_torch.models import build_model
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    cfg = lbbdm_f4_config()
    cfg.model.BB.params.sample_step = SAMPLE_STEP
    cfg.testing.sample_num = SAMPLE_NUM
    cfg.model.VQGAN.params.ckpt_path = None  # seeded random VQGAN weights
    log("reduced: " + json.dumps({"sample_step": {"template": 200, "run": SAMPLE_STEP},
                                  "sample_num": {"template": 5, "run": SAMPLE_NUM},
                                  "weights": "random, seed 0", "batches": BATCHES}))
    t0 = time.time()
    runner = BBDMRunner(cfg, device=dev, seed=0)
    model = runner.model
    torch.cuda.synchronize()
    log(f"  model: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
        f"built in {time.time() - t0:.1f} s")

    size = cfg.data.dataset_config.image_size
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:size, 0:size] / size
    batches = []
    for bi in range(BATCHES):
        phase = rs.uniform(0, 2 * np.pi, (BATCH, 1, 1, 3))
        smooth = np.sin(6 * yy[None, :, :, None] + 4 * xx[None, :, :, None] + phase)
        noise = rs.uniform(-0.2, 0.2, (BATCH, size, size, 3))
        batches.append({
            "x": np.clip(-smooth + noise, -1, 1).astype(np.float32),
            "x_cond": np.clip(smooth + noise, -1, 1).astype(np.float32),
            "x_name": [f"img{bi}_{i}" for i in range(BATCH)],
            "x_cond_name": [f"cond{bi}_{i}" for i in range(BATCH)],
        })

    # kernels vs plain twins on the card: same weights, same noise, latent before
    # quantisation; an fp32 run through the twins says how far bf16 alone moves it
    x_cond = torch.from_numpy(batches[0]["x_cond"]).permute(0, 3, 1, 2).to(dev)
    y = model.encode(x_cond)
    g = torch.Generator(dev).manual_seed(1)
    noise = [torch.randn(y.shape, generator=g, device=dev) for _ in model.coeffs.steps]
    z_kernel = model.p_sample_loop(y, noise=noise, clip_denoised=False)
    torch.cuda.synchronize()
    t0 = time.time()
    z_kernel = model.p_sample_loop(y, noise=noise, clip_denoised=False)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / len(noise)
    with plain_ops():
        y_plain = model.encode(x_cond)
        z_plain = model.p_sample_loop(y, noise=noise, clip_denoised=False)
        torch.cuda.synchronize()
        t0 = time.time()
        z_plain = model.p_sample_loop(y, noise=noise, clip_denoised=False)
        torch.cuda.synchronize()
        plain_step_s = (time.time() - t0) / len(noise)
        ref32 = build_model(cfg.model, device=dev, dtype=torch.float32)
        ref32.load_state_dict(model.state_dict())
        y_32 = ref32.encode(x_cond)
        z_32 = ref32.p_sample_loop(y, noise=noise, clip_denoised=False)
        del ref32
    img = model.decode(z_kernel)
    torch.cuda.synchronize()
    d = lambda a, b: float((a.float() - b.float()).abs().max())
    dist = {"encode_kernel_vs_plain": d(y, y_plain), "encode_bf16_vs_fp32": d(y_plain, y_32),
            "latent_kernel_vs_plain": d(z_kernel, z_plain),
            "latent_bf16_vs_fp32": d(z_plain, z_32), "latent_max_abs": float(z_32.abs().max())}
    log("  path agreement: " + json.dumps(dist))
    if not (torch.isfinite(z_kernel).all() and torch.isfinite(img).all()):
        raise AssertionError("non-finite latent or image")
    if tuple(img.shape) != (BATCH, 3, size, size):
        raise AssertionError(f"decoded image shape {tuple(img.shape)}")
    # bar: the kernel and twin bf16 runs round at different places, each about
    # as far from the fp32 run as the other, so they may be up to twice the
    # twin's bf16-vs-fp32 distance apart
    for what in ("encode", "latent"):
        if dist[f"{what}_kernel_vs_plain"] > 2 * dist[f"{what}_bf16_vs_fp32"]:
            raise AssertionError(f"{what}: kernel path farther from the twins than 2x bf16 error")
    log(f"  seconds per sampler step (batch {BATCH}): kernels {step_s:.4f}, "
        f"plain twins {plain_step_s:.4f}")

    # the main path, counted: sample_to_eval through the runner
    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="bbdm_smoke_") as out_dir:
        t0 = time.time()
        runner.sample_to_eval(batches, out_dir)
        torch.cuda.synchronize()
        total = time.time() - t0
        launches = {name: getattr(mod, attr).launches for name, (mod, attr) in counters.items()}
        log(f"  sample_to_eval: {total:.2f} s for {BATCHES} batches of {BATCH} "
            f"({total / BATCHES:.2f} s per batch), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}")
        check_tree(out_dir, [n for b in batches for n in b["x_name"]],
                   [n for b in batches for n in b["x_cond_name"]], SAMPLE_STEP, SAMPLE_NUM, size)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    return launches, {"sampler_step_s": step_s, "plain_sampler_step_s": plain_step_s,
                      "sample_to_eval_batch_s": total / BATCHES, **dist}


def check_tree(out_dir, names, conds, step, sample_num, size):
    """The sample_to_eval output contract, and that the outputs are PNGs of the image size."""
    listing = lambda *p: sorted(os.listdir(os.path.join(out_dir, *p)))
    expect = {(): sorted(["condition", "ground_truth", str(step)]),
              ("condition",): sorted(f"{n}.png" for n in conds),
              ("ground_truth",): sorted(f"{n}.png" for n in names)}
    if sample_num > 1:
        expect[(str(step),)] = sorted(names)
        expect.update({(str(step), n): [f"output_{j}.png" for j in range(sample_num)]
                       for n in names})
        first = os.path.join(out_dir, str(step), names[0], "output_0.png")
    else:
        expect[(str(step),)] = sorted(f"{n}.png" for n in names)
        first = os.path.join(out_dir, str(step), f"{names[0]}.png")
    for path, files in expect.items():
        if listing(*path) != files:
            raise AssertionError(f"sample_to_eval tree: {path} holds {listing(*path)}")
    check_png(first, size, size)


def check_png(path, height, width):
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[16:24] != (width.to_bytes(4, "big")
                                                            + height.to_bytes(4, "big")):
        raise AssertionError(f"{path} is not a {width}x{height} PNG")


# ---------------------------------------------------------------------- CLI

@contextlib.contextmanager
def timed(cls, attr, store):
    """Record the wall seconds of each ``cls.attr`` call in ``store`` (synchronised)."""
    fn = getattr(cls, attr)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - t0)
        return out

    setattr(cls, attr, wrapper)
    try:
        yield store
    finally:
        setattr(cls, attr, fn)


def write_dataset(root, size, pairs, seed):
    """A ``custom_aligned`` PNG dataset: ``<stage>/A`` conditions, ``<stage>/B``
    targets (2 train and 2 val pairs, ``pairs`` test pairs), written by the port."""
    import numpy as np

    from bbdm_tpu_torch.utils.images import to_uint8, write_png

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for stage, n in (("train", 2), ("val", 2), ("test", pairs)):
        for side in "AB":
            os.makedirs(os.path.join(root, stage, side), exist_ok=True)
        for i in range(n):
            smooth = np.sin(6 * yy[..., None] + 4 * xx[..., None] + rs.uniform(0, 2 * np.pi, 3))
            noise = rs.uniform(-0.2, 0.2, (size, size, 3))
            for side, img in (("A", smooth + noise), ("B", -smooth + noise)):
                write_png(os.path.join(root, stage, side, f"{i:04d}.png"),
                          to_uint8(np.clip(img, -1, 1)))


def write_checkpoints(cfg, dev, path, vqgan_path=None):
    """A model checkpoint whose ``model`` and ``ema`` UNets (and condition stages)
    come from two seeds, with one frozen VQGAN; for an LBBDM also that VQGAN
    alone at ``vqgan_path``. Returns the ``ema`` tree."""
    from bbdm_tpu_torch.checkpoints.from_jax import jax_tree_from_state_dict
    from bbdm_tpu_torch.checkpoints.io import save_checkpoint
    from bbdm_tpu_torch.models import build_model

    trees = []
    for seed in (11, 12):
        m = build_model(cfg.model, device=dev, generator=torch.Generator(dev).manual_seed(seed))
        trees.append(jax_tree_from_state_dict(m))
        del m
    model, other = trees
    ema = dict(model, **{k: other[k] for k in ("unet", "cond_stage") if k in other})
    if vqgan_path:
        save_checkpoint({"vqgan": model["vqgan"]}, vqgan_path)
    save_checkpoint({"model": model, "ema": ema, "step": 1000, "epoch": 10}, path)
    return ema


def read_pngs(root):
    """{relative path: uint8 array} of every PNG under ``root``."""
    from bbdm_tpu_torch.utils.images import read_png

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                out[os.path.relpath(os.path.join(d, f), root)] = read_png(os.path.join(d, f))
    return out


def png_decode_ms(size=256, reps=3):
    """Host ms to decode a size^2 RGB PNG whose rows all use one filter, per filter."""
    import zlib

    import numpy as np

    from bbdm_tpu_torch.utils import images

    rs = np.random.RandomState(0)
    rows = rs.randint(0, 256, (size, 1 + 3 * size)).astype(np.uint8)
    out = {}
    for f, name in enumerate(("none", "sub", "up", "average", "paeth")):
        rows[:, 0] = f
        data = zlib.decompress(zlib.compress(rows.tobytes()))
        t0 = time.perf_counter()
        for _ in range(reps):
            images._unfilter(data, size, size, 3)
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    return out


def cli_phase(dev, counters, root, gpu_ids="0", step=SAMPLE_STEP, pairs=CLI_TEST_PAIRS,
              configs=None):
    """Drive ``main_torch.main`` over synthetic datasets (see the module
    docstring, phase 5); ``configs`` (name -> ConfigNode, default the two
    templates) lets a CPU rehearsal pass tiny models."""
    import numpy as np

    import main_torch
    from bbdm_tpu_torch.checkpoints.from_jax import state_dict_from_jax
    from bbdm_tpu_torch.config import load_config, save_config
    from bbdm_tpu_torch.data import DataLoader, get_dataset
    from bbdm_tpu_torch.profile_slice import measure
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    here = os.path.dirname(os.path.abspath(__file__))
    if configs is None:
        configs = {name: load_config(os.path.join(here, "configs", f"Template-{name}.yaml"))
                   for name in ("LBBDM-f4", "BBDM")}
    out = {"png_decode_ms_256": png_decode_ms()}
    log("  PNG decode, host ms per 256^2 RGB image by row filter: "
        + json.dumps(out["png_decode_ms_256"]))
    paths, emas = {}, {}
    for name, cfg in configs.items():
        size = cfg.data.dataset_config.image_size
        data = os.path.join(root, f"data-{name}")
        write_dataset(data, size, pairs, seed=len(paths))
        cfg.data.dataset_config.dataset_path = data
        cfg.model.BB.params.sample_step = step
        vq = None
        if cfg.model.model_type == "LBBDM":
            vq = cfg.model.VQGAN.params.ckpt_path = os.path.join(root, f"{name}-vqgan.ckpt")
        t0 = time.time()
        emas[name] = write_checkpoints(cfg, dev, os.path.join(root, f"{name}.ckpt"), vq)
        log(f"  {name}: dataset and checkpoints written in {time.time() - t0:.1f} s")
        for sampler, num in (("euler", 2), ("heun", 1), ("euler", 1)):
            cfg.model.BB.params.sampler = sampler
            cfg.testing.sample_num = num
            paths[name, sampler, num] = os.path.join(root, f"{name}-{sampler}-{num}.yaml")
            save_config(cfg, paths[name, sampler, num])

    (f4, bbdm) = configs
    runs = (("f4_euler_sample_to_eval", f4, "euler", 2, True, ("K1", "K2", "K3")),
            ("f4_heun_sample_to_eval", f4, "heun", 1, True, ("K1", "K2", "K3")),
            ("bbdm_grid", bbdm, "euler", 1, False, ("K1", "K2")),
            ("bbdm_sample_to_eval", bbdm, "euler", 1, True, ("K1", "K2")))
    names = [f"{i:04d}" for i in range(pairs)]
    launches, runners = {}, {}
    short = {"group_norm": "K1", "subpixel_upconv": "K2", "flash_attention": "K3"}
    for label, name, sampler, num, to_eval, needed in runs:
        result = os.path.join(root, f"results-{label}")
        argv = ["-c", paths[name, sampler, num], "--resume_model",
                os.path.join(root, f"{name}.ckpt"), "-r", result, "-s", str(CLI_SEED),
                "--gpu_ids", gpu_ids] + (["--sample_to_eval"] if to_eval else [])
        for mod, attr in counters.values():
            getattr(mod, attr).launches = 0
        sweeps = []
        t0 = time.time()
        with timed(BBDMRunner, "sample_to_eval", sweeps):
            runner = main_torch.main(argv)
        total = time.time() - t0
        launches[label] = {short[k]: getattr(mod, attr).launches
                           for k, (mod, attr) in counters.items()}
        cfg = runner.config
        tree = cfg.result.sample_to_eval_path if to_eval else os.path.join(
            cfg.result.sample_path, "0", "test_sample")
        size = cfg.data.dataset_config.image_size
        if to_eval:
            check_tree(tree, names, names, step, num, size)
        else:
            if sorted(os.listdir(tree)) != ["condition.png", "ground_truth.png",
                                            "skip_sample.png"]:
                raise AssertionError(f"grid mode wrote {sorted(os.listdir(tree))}")
            cols = min(4, cfg.data.test.batch_size)  # the grid holds the first 4 images
            check_png(os.path.join(tree, "skip_sample.png"), size + 4, cols * (size + 2) + 2)
        batches = pairs // cfg.data.test.batch_size
        entry = {"launches": launches[label], "wall_s": total}
        if sweeps:
            entry["sample_to_eval_batch_s"] = sweeps[0] / batches
        log(f"  {label}: {total:.1f} s in main_torch.main"
            + (f", {entry['sample_to_eval_batch_s']:.3f} s per sample_to_eval batch of "
               f"{cfg.data.test.batch_size} ({num} draw(s), {step} steps)" if sweeps else "")
            + f", launches {launches[label]}")
        missing = [k for k in needed if launches[label][k] <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels {missing} were not launched")
        if (runner.global_epoch, runner.global_step) != (10, 1000):
            raise AssertionError(f"{label}: checkpoint epoch and step not read")
        out[label] = entry
        runners[label] = runner

    # the CLI's euler run against an in-process runner with the same EMA weights and seed
    euler = runners["f4_euler_sample_to_eval"]
    ref_cfg = load_config(paths[f4, "euler", 2])
    ref = BBDMRunner(ref_cfg, device=euler.device, seed=CLI_SEED)
    ref.model.load_state_dict(state_dict_from_jax(emas[f4], ref.model))
    test_ds = get_dataset(ref_cfg.data)[2]
    loader = DataLoader(test_ds, ref_cfg.data.test.batch_size)
    ref_dir = os.path.join(root, "in-process")
    ref.sample_to_eval(loader, ref_dir)
    cli_png, ref_png = read_pngs(euler.config.result.sample_to_eval_path), read_pngs(ref_dir)
    if sorted(cli_png) != sorted(ref_png):
        raise AssertionError("CLI and in-process sample_to_eval trees differ")
    worst = max(int(np.abs(cli_png[k].astype(int) - ref_png[k]).max()) for k in cli_png)
    out["f4_euler_cli_vs_in_process_max_uint8"] = worst
    log(f"  f4 euler CLI vs in-process runner (same EMA weights, seed {CLI_SEED}): "
        f"{len(cli_png)} PNGs, max difference {worst} uint8 level(s)")
    if worst > 1:
        raise AssertionError("CLI output differs from the in-process runner by > 1 level")
    del ref

    # the card's idle share over one CLI batch (PNG writes included)
    batch = next(iter(loader))
    wall, busy, _ = measure(lambda: euler.sample_to_eval([batch], os.path.join(root, "idle")),
                            2, 1)
    out["f4_euler_batch_wall_ms"], out["f4_euler_batch_device_busy_ms"] = wall, busy
    out["f4_euler_batch_idle_share"] = 1 - busy / wall
    log(f"  f4 euler sample_to_eval batch: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall:.0%}")
    del euler, runners["f4_euler_sample_to_eval"]

    # heun through the kernels against heun through the twins, same noise
    heun = runners["f4_heun_sample_to_eval"]
    model = heun.model
    x_cond = torch.from_numpy(batch["x_cond"]).permute(0, 3, 1, 2).to(heun.device)
    y = model.encode(x_cond)
    g = torch.Generator(heun.device).manual_seed(2)
    noise = [torch.randn(y.shape, generator=g, device=heun.device)
             for _ in range(model.noised_steps())]
    z_kernel = model.p_sample_loop(y, noise=noise, clip_denoised=False)
    torch.cuda.synchronize()
    t0 = time.time()
    z_kernel = model.p_sample_loop(y, noise=noise, clip_denoised=False)
    torch.cuda.synchronize()
    out["heun_step_s"] = (time.time() - t0) / (len(model.coeffs.steps) - 1)
    with plain_ops():
        z_plain = model.p_sample_loop(y, noise=noise, clip_denoised=False)
        ref32 = build_fp32_copy(heun.config.model, model, heun.device)
        z_32 = ref32.p_sample_loop(y, noise=noise, clip_denoised=False)
        del ref32
    d = lambda a, b: float((a.float() - b.float()).abs().max())
    out["heun_latent_kernel_vs_plain"] = d(z_kernel, z_plain)
    out["heun_latent_bf16_vs_fp32"] = d(z_plain, z_32)
    log(f"  heun (f4, {len(model.coeffs.steps)}-entry grid, two UNet evals per step): "
        f"{out['heun_step_s']:.4f} s per step; latent kernel vs plain "
        f"{out['heun_latent_kernel_vs_plain']:.4f}, plain bf16 vs fp32 "
        f"{out['heun_latent_bf16_vs_fp32']:.4f}")
    if not torch.isfinite(z_kernel).all():
        raise AssertionError("heun: non-finite latent")
    if out["heun_latent_kernel_vs_plain"] > 2 * out["heun_latent_bf16_vs_fp32"]:
        raise AssertionError("heun: kernel path farther from the twins than 2x bf16 error")
    return launches, out


def build_fp32_copy(model_config, model, dev):
    """An fp32 copy of ``model`` (same weights) for the twin-vs-bf16 distance."""
    from bbdm_tpu_torch.models import build_model

    ref = build_model(model_config, device=dev, dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    return ref


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "bbdm_tpu_torch")):
        print("chip_smoke.py: bbdm_tpu_torch/ not found; run it from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card", file=sys.stderr)
        return 2
    import bbdm_tpu_torch  # noqa: F401  (sets TF32 off)
    from bbdm_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    failed = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""
    log(card or "nvidia-smi: no answer")
    if not card:
        failed.append("environment")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"tf32 cudnn={torch.backends.cudnn.allow_tf32} "
        f"matmul={torch.backends.cuda.matmul.allow_tf32}")

    try:
        t0 = time.time()
        path = build.build()
        build.library()
        log(f"kernel build: {time.time() - t0:.1f} s ({os.path.basename(path)})")
        with open(path[:-3] + ".log") as f:
            for line in f:
                if any(key in line for key in ("Compiling entry", "Used", "spill", "warning",
                                               "build time")):
                    log("  " + line.strip())
    except Exception:
        traceback.print_exc()
        log("kernel build: FAILED")
        return 1

    entries, counters = [], {}
    for name, route, source, replaces, counter, pattern, cases in kernel_cases(dev):
        counters[name] = counter
        try:
            t0 = time.time()
            e = kernel_phase(name, counter, pattern, cases)
            log(f"kernel {name}: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append(name)
            e = {}
        entries.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": 0, **e})
        torch.cuda.empty_cache()

    timings = {}
    try:
        t0 = time.time()
        launches, timings = slice_phase(dev, counters)
        for e in entries:
            e["launches"] = launches[e["name"]]
        log(f"slice: ok ({time.time() - t0:.1f} s)")
    except Exception:
        traceback.print_exc()
        failed.append("slice")

    cli = {}
    try:
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="bbdm_smoke_cli_") as root:
            by_path, cli = cli_phase(dev, counters, root)
        short = {"group_norm": "K1", "subpixel_upconv": "K2", "flash_attention": "K3"}
        for e in entries:
            e["launches_by_path"] = {"slice_sample_to_eval": e["launches"],
                                     **{p: n[short[e["name"]]] for p, n in by_path.items()}}
        log(f"cli: ok ({time.time() - t0:.1f} s)")
    except Exception:
        traceback.print_exc()
        failed.append("cli")

    log(json.dumps({"kernels": entries, "slice": timings, "cli": cli, "card": card}))
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
