#!/usr/bin/env python3
"""Drive the PyTorch port (``bbdm_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which must pass:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, TF32 off;
2. kernel build: nvcc of ``bbdm_tpu_torch/csrc/*.cu`` for sm_90a;
3. each hand-written kernel (K1 GroupNorm, K2 subpixel up-conv, K3 flash
   attention, all CUDA C++; K2 and K3 in bf16 and, from their ``*_f32.cu``
   sources, in fp32) against its plain PyTorch twin on the card at the shapes
   the LBBDM-f4 path (bf16) and VQGAN-f4 training (fp32) give it and at edge
   cases, one launch per call;
   at the path shapes also CUDA-event times of the kernel (wrapper included),
   its twin and one PyTorch library call computing the same function (or, for
   K1, a subset of it), the kernel's own device time from torch.profiler, and
   its bound: the larger of its bytes over 3.35 TB/s and its operations over
   the peak rate for their type (H100 SXM data sheet). The fp32 K2 and K3
   compute in 3xTF32: their bound takes three TF32 passes at 495 TFLOP/s, and
   the bound of the same work as fp32 FMAs (67 TFLOP/s) is printed beside it;
   at each of their path shapes the function with one TF32 pass
   (``ops.tf32_round`` inputs) must miss the bar the kernel meets;
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
   share over one CLI batch; the host's PNG decode time per 256^2 image;
6. training, ``main_torch.main([... "--train"])``, at full width on a
   synthetic 256^2 ``custom_aligned`` dataset (32 train, 8 val, 8 test pairs)
   with phase 5's VQGAN checkpoint and a text copy of
   ``Template-LBBDM-f4.yaml`` (batch 8, ``accumulate_grad_batches`` 4, Adam)
   cut to ``--max_epoch 4`` (16 microbatches, 4 optimizer updates) with
   ``normalize_latent`` (the latent statistics pass runs), an EMA from step 0
   and one mid-training sample: seconds per microbatch and per optimizer
   update, peak device memory, the kernels' launches, K1's gradient
   recomputes and their time, the card's idle share over two microbatches
   and the checkpoint files; then the trained ``last_model.ckpt`` samples
   through ``--sample_to_eval``, and one microbatch through the kernels is
   held against the same microbatch through the twins (loss and flattened
   gradient, bar: twice the twins' bf16-vs-fp32 gap), every trainable
   gradient finite and present and the VQGAN without one;
7. VQGAN training, ``main_torch.main([... "--train"])`` with a text copy of
   ``Template-VQGAN-f4.yaml`` at full width (ch 128 x (1,2,4), 2 res blocks,
   256^2, n_embed 8192, PatchGAN ndf 64 with 3 layers, batch 8, fp32) with
   ``disc_start`` 0 (the adversarial terms and the adaptive d_weight live) and
   no perceptual term, on a synthetic 256^2 ``custom_single`` dataset (16
   train, 8 val, 8 test images, no flip) cut to 2 epochs (4 steps) with one sample
   grid, one validation epoch and one save: seconds per step, peak memory,
   the idle share over two steps, the kernels' launches (K1 and K3 with
   gradients, K2 in the eval-mode validation and sample); one step through
   the kernels against the twins with the kernels' codes (reconstruction,
   generator loss, generator and discriminator gradients against the fixed
   ``VQ_STEP_BARS``, which the twins run twice must pass and the twins with
   TF32 must fail, each reading printed against its bar with the number of
   codes the kernels pick differently; d_weight and the discriminator loss
   printed), every parameter of both players with a finite gradient; K3's
   device ms per step; then
   ``--sample_to_eval`` from its ``last_model.ckpt`` and that file as an
   LBBDM-f4 first stage for one encode and decode.

Phase 3 also holds K1 (UNet shape, FiLM + SiLU) and K3 (the VQGAN attention,
bf16 and fp32) through their autograd Functions: the output equal to the kernel's and the
gradients equal, bit for bit, to the twin's autograd gradients (the backward
is that recompute), with the backward's time.

Prints the kernels' JSON line (each kernel's errors and sums over its timed
shapes for the 16-bit cases at the top of its entry, for the fp32 cases in
its ``fp32`` block), then as its last line
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


def attention_one_tf32_pass(q, k, v):
    """K3 fp32's function with one TF32 pass where the kernel makes three: q*D^-1/4,
    k*D^-1/4, the softmax weights and v rounded to TF32 (``ops.tf32_round``),
    products of TF32 values exact in fp32 (TF32 off), fp32 sums."""
    from bbdm_tpu_torch.ops import tf32_round

    scale = q.shape[-1] ** -0.25
    logits = tf32_round(q * scale) @ tf32_round(k * scale).transpose(-1, -2)
    return tf32_round(torch.softmax(logits, dim=-1)) @ tf32_round(v)


def upconv_one_tf32_pass(x, w, b):
    """K2 fp32's function on x and the 3x3 taps rounded to TF32 (one pass)."""
    from bbdm_tpu_torch.ops import tf32_round, upsample_conv

    return upsample_conv.upsample_conv_plain(tf32_round(x), tf32_round(w), b)


def bar_excess(out, ref, rtol, atol):
    """max |out - ref| / (atol + rtol |ref|): <= 1 within the bar."""
    return float(((out.float() - ref.float()).abs() / (atol + rtol * ref.float().abs())).max())


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
    """(name, route, sources, replaces, counter, kernel-name fragments, cases); each
    case (bf16, and for K2 and K3 also fp32, whose kernels are the second
    source) is (label, run_kernel, run_plain, rtol, atol, work): work None marks an
    edge case that is checked but not timed, else a dict with the case's
    ``flops``, done ``passes`` times at ``peak`` FLOP/s (the fp32 K2 and K3: 3
    TF32 passes, and ``fma_peak`` for the bound of the same work as fp32 FMAs),
    its ``bytes`` (each input read once, each output written once), its
    ``library`` call (or None) and, for the fp32 K2 and K3, ``one_pass``: the
    function with one TF32 pass, which must miss the bar the kernel meets."""
    import torch.nn.functional as F

    from bbdm_tpu_torch.ops import (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, attention,
                                    group_norm, upsample_conv)

    g = torch.Generator(dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    gn = []
    # timed: UNet up_0_0.in_norm at 64^2 (C=640), UNet up_2_us.out_norm with FiLM
    # (C=1024 at 32^2), VQGAN decoder up_0_block_0.norm1 (C=256 at 256^2); then
    # the edge cases of the gpu-marked tests: a span that overflows a cluster of 8
    # (fp32 at 256^2), a ragged span (C=96 at 7x5), fp16 with FiLM, a cluster of
    # 4, and a ragged span split over a cluster of 2; then timed fp32 at VQGAN
    # training's three widths (encoder and decoder norms at 256^2, 128^2, 64^2)
    for shape, film, eps, dtype, timed in (
            ((BATCH, 640, 64, 64), False, 1e-5, torch.bfloat16, True),
            ((BATCH, 1024, 32, 32), True, 1e-5, torch.bfloat16, True),
            ((BATCH, 256, 256, 256), False, 1e-6, torch.bfloat16, True),
            ((1, 256, 256, 256), False, 1e-6, torch.float32, False),
            ((2, 96, 7, 5), False, 1e-5, torch.bfloat16, False),
            ((2, 320, 24, 24), True, 1e-5, torch.float16, False),
            ((2, 256, 128, 128), False, 1e-6, torch.bfloat16, False),
            ((2, 32, 255, 255), True, 1e-6, torch.bfloat16, False),
            ((BATCH, 128, 256, 256), False, 1e-6, torch.float32, True),
            ((BATCH, 256, 128, 128), False, 1e-6, torch.float32, True),
            ((BATCH, 512, 64, 64), False, 1e-6, torch.float32, True)):
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
    # one that pads every dimension (ci % 8, co < 128, h < one tile of rows, w % 4);
    # then fp32 (VQGAN training's eval-mode reconstructions) at the decoder's two
    # shapes and the same edge cases
    for (n, ci, h, wd), co, dtype, timed in (
            ((BATCH, 1024, 16, 16), 1024, torch.bfloat16, True),
            ((BATCH, 512, 32, 32), 512, torch.bfloat16, True),
            ((BATCH, 512, 64, 64), 512, torch.bfloat16, True),
            ((BATCH, 256, 128, 128), 256, torch.bfloat16, True),
            ((1, 32, 24, 40), 96, torch.bfloat16, False),
            ((2, 64, 16, 16), 64, torch.bfloat16, False),
            ((1, 20, 5, 7), 30, torch.bfloat16, False),
            ((BATCH, 512, 64, 64), 512, torch.float32, True),
            ((BATCH, 256, 128, 128), 256, torch.float32, True),
            ((1, 32, 24, 40), 96, torch.float32, False),
            ((2, 64, 16, 16), 64, torch.float32, False),
            ((1, 20, 5, 7), 30, torch.float32, False)):
        f32 = dtype == torch.float32
        x = randn(n, ci, h, wd, dtype=dtype)
        w = randn(co, ci, 3, 3, scale=0.02, dtype=torch.float32)
        b = randn(co, scale=0.1, dtype=torch.float32)
        kp = upsample_conv.combine_kernel_2x2(w).to(dtype)
        w4, bl = upconv_transposed_kernel(w).to(dtype), b.to(dtype)
        size = x.element_size()
        work = dict(flops=2 * n * h * wd * 16 * ci * co,
                    peak=PEAK_TF32_FLOPS if f32 else PEAK_BF16_FLOPS, passes=3 if f32 else 1,
                    bytes=size * (x.numel() + kp.numel() + 4 * n * h * wd * co) + 4 * co,
                    library=lambda x=x, w4=w4, bl=bl: F.conv_transpose2d(
                        x, w4, bl, stride=2, padding=1),
                    library_call="F.conv_transpose2d(x, W4, b, stride=2, padding=1)")
        if f32:
            work.update(fma_peak=PEAK_FP32_FLOPS,
                        one_pass=lambda x=x, w=w, b=b: upconv_one_tf32_pass(x, w, b))
        up.append((f"{[n, ci, h, wd]}->{co}{' fp32' if f32 else ''}",
                   lambda x=x, kp=kp, b=b: upsample_conv.upsample_conv_cuda(x, kp, b),
                   lambda x=x, w=w, b=b, dtype=dtype: upsample_conv.upsample_conv_plain(
                       x, w, b, dtype=dtype),
                   # bf16: the kernel's phase taps are fp32 sums rounded to bf16 once,
                   # the twin's 3x3 taps are rounded one by one: 2^-8 relative per tap,
                   # plus one output rounding each; fp32: 3xTF32 (~2^-22 per product)
                   # against fp32 FMAs (TF32 off), summed in another order
                   *((1e-4, 1e-4) if f32 else (2 ** -5, 2 ** -5)), work if timed else None))

    fa = []
    # VQGAN encoder / decoder mid_attn_1: H=1, T=64^2, D=512; then the edge cases of
    # the gpu-marked tests: ragged T (keys masked, rows not written) and D=128; then
    # T and D below one 64 x 64 box; then the same in fp32 (VQGAN training)
    for shape, dtype, timed in (((BATCH, 1, 4096, 512), torch.bfloat16, True),
                                ((1, 2, 1100, 128), torch.bfloat16, False),
                                ((2, 1, 1024, 512), torch.bfloat16, False),
                                ((1, 1, 50, 48), torch.bfloat16, False),
                                ((BATCH, 1, 4096, 512), torch.float32, True),
                                ((1, 2, 1100, 128), torch.float32, False),
                                ((2, 1, 1024, 512), torch.float32, False),
                                ((1, 1, 50, 48), torch.float32, False)):
        f32 = dtype == torch.float32
        q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
        B, H, T, D = shape
        work = dict(flops=4 * B * H * T * T * D, peak=PEAK_TF32_FLOPS if f32 else PEAK_BF16_FLOPS,
                    passes=3 if f32 else 1, bytes=4 * q.numel() * q.element_size(),
                    library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                        q, k, v, scale=q.shape[-1] ** -0.5),
                    library_call="F.scaled_dot_product_attention(q, k, v, scale=D**-0.5)",
                    backends=lambda q=q, k=k, v=v: sdpa_backends(q, k, v))
        if f32:
            work.update(fma_peak=PEAK_FP32_FLOPS,
                        one_pass=lambda q=q, k=k, v=v: attention_one_tf32_pass(q, k, v))
        fa.append((f"{list(shape)}{' fp32' if f32 else ''}",
                   lambda q=q, k=k, v=v: attention.flash_attention_cuda(q, k, v),
                   lambda q=q, k=k, v=v: attention.attention_plain(q, k, v),
                   # bf16: the twin rounds q*D^-1/4 and k*D^-1/4 to bf16 (as
                   # _xla_attention does; the kernel scales the fp32 scores), and both
                   # round the probabilities to bf16: 2^-8 relative each, over T keys;
                   # fp32: 3xTF32 products (~2^-22 each) against fp32 FMAs (TF32 off),
                   # an online softmax against one pass
                   *((1e-4, 1e-5) if f32 else (2 ** -6, 2 ** -7)), work if timed else None))

    return [
        ("group_norm", "cuda", ["bbdm_tpu_torch/csrc/group_norm.cu"],
         "bbdm_tpu/ops/group_norm_pallas.py:178", (group_norm, "group_norm_cuda"),
         {None: "group_norm_kernel", "fp32": "group_norm_kernel"}, gn),
        ("subpixel_upconv", "cuda", ["bbdm_tpu_torch/csrc/subpixel_upconv.cu",
                                     "bbdm_tpu_torch/csrc/subpixel_upconv_f32.cu"],
         "bbdm_tpu/ops/subpixel_pallas.py:133", (upsample_conv, "upsample_conv_cuda"),
         {None: "subpixel_upconv_kernel", "fp32": "subpixel_upconv_f32_kernel"}, up),
        ("flash_attention", "cuda", ["bbdm_tpu_torch/csrc/flash_attention.cu",
                                     "bbdm_tpu_torch/csrc/flash_attention_f32.cu"],
         "bbdm_tpu/ops/flash_attention.py:115", (attention, "flash_attention_cuda"),
         {None: "flash_attention_kernel", "fp32": "flash_attention_f32_kernel"}, fa),
    ]


def kernel_phase(name, counter, patterns, cases):
    """Check each case against the twin (and that it is one launch); time the
    path shapes; where the case has a one-TF32-pass control, check that it
    misses the bar the kernel meets; returns the kernel's JSON entry: errors
    and sums over the timed shapes of the 16-bit cases at its top level, those
    of the fp32 cases in its ``fp32`` block (``patterns``: the device kernel's
    name fragment of each, keyed None and "fp32"; every kernel of a call,
    pre-passes included, carries it). The fp32 block also sums the bound of
    the same work as fp32 FMAs (``bound_fma_ms``) where the cases give one."""
    from bbdm_tpu_torch.ops import PEAK_BYTES_S

    mod, attr = counter
    blocks = {key: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                    "bound_ms": 0.0, "bound_by": None, "library_ms": 0.0}
              for key in (None, "fp32")}
    seconds = {key: [0.0, 0.0] for key in blocks}  # ops, bytes
    fma_s = {key: 0.0 for key in blocks}
    entry = {**blocks[None], "fp32": blocks["fp32"], "shapes": []}
    blocks[None] = entry
    ok = True
    for label, run, plain, rtol, atol, work in cases:
        before = getattr(mod, attr).launches
        out = run()
        launched = getattr(mod, attr).launches - before
        ref = plain()
        torch.cuda.synchronize()
        key = "fp32" if out.dtype == torch.float32 else None
        block = blocks[key]
        abs_err, rel_err, good = compare(out, ref, rtol, atol)
        good &= launched == 1
        line = (f"  {name} {label}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
                f"(bar |d| <= {atol:g} + {rtol:g}|ref|), launches {launched} "
                f"{'ok' if good else 'FAIL'}")
        shape = {"shape": label, "max_abs_err": abs_err}
        if work is None:
            line += "; edge case, not timed"
        else:
            if "one_pass" in work:
                control = work["one_pass"]()
                shape["excess"] = bar_excess(out, ref, rtol, atol)
                shape["one_pass_excess"] = bar_excess(control, ref, rtol, atol)
                missed = not compare(control, ref, rtol, atol)[2]
                good &= missed
                line += (f"; |d|/bar kernel {shape['excess']:.3f}, one TF32 pass "
                         f"{shape['one_pass_excess']:.2f} ({'misses' if missed else 'MEETS'} "
                         f"the bar)")
                del control
            ms, plain_ms, lib_ms = cuda_ms(run), cuda_ms(plain), cuda_ms(work["library"])
            dev = sum(v for k, v in kernel_times_us(run).items() if patterns[key] in k)
            t_ops = work.get("passes", 1) * work["flops"] / work["peak"]
            t_bytes = work["bytes"] / PEAK_BYTES_S
            bound_us = max(t_ops, t_bytes) * 1e6
            seconds[key][0] += t_ops
            seconds[key][1] += t_bytes
            shape.update(ms=ms, plain_ms=plain_ms, device_us=dev or None, bound_us=bound_us,
                         bound_by="operations" if t_ops > t_bytes else "bytes",
                         library_ms=lib_ms, library_call=work["library_call"])
            line += (f"; kernel {ms:.4f} ms (device {dev:.1f} us), plain {plain_ms:.4f} ms, "
                     f"library {lib_ms:.4f} ms; bound {bound_us:.1f} us "
                     f"({shape['bound_by']}), {bound_us / dev:.0%} of it" if dev else
                     "; device time not measured")
            if "fma_peak" in work:
                t_fma = work["flops"] / work["fma_peak"]
                fma_s[key] += max(t_fma, t_bytes)
                shape["bound_fma_us"] = max(t_fma, t_bytes) * 1e6
                line += (f"; as fp32 FMAs bound {shape['bound_fma_us']:.1f} us"
                         + (f", {shape['bound_fma_us'] / dev:.0%} of it" if dev else ""))
            if "backends" in work:
                shape["library_backends"] = work["backends"]()
                line += f"; sdpa backends {shape['library_backends']}"
            block["ms"] += ms
            block["plain_ms"] += plain_ms
            block["library_ms"] += lib_ms
        log(line)
        entry["shapes"].append(shape)
        block["max_abs_err"] = max(block["max_abs_err"], abs_err)
        block["max_rel_err"] = max(block["max_rel_err"], rel_err)
        ok &= good
        del out, ref
    for key, (ops_s, bytes_s) in seconds.items():
        blocks[key]["bound_ms"] = max(ops_s, bytes_s) * 1e3
        blocks[key]["bound_by"] = "operations" if ops_s > bytes_s else "bytes"
        if fma_s[key]:
            blocks[key]["bound_fma_ms"] = fma_s[key] * 1e3
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    return entry


def autograd_cases(dev):
    """[(kernel name, block key, (label, inputs requiring grad, call through the
    dispatcher, the kernel alone, the twin))] for the kernels with an autograd
    Function: K1 at the UNet's FiLM + SiLU shape (bf16 x and FiLM, fp32 affine),
    K3 at the VQGAN attention's in bf16 and in fp32 (VQGAN training)."""
    from bbdm_tpu_torch.ops import attention, group_norm

    g = torch.Generator(dev).manual_seed(3)
    randn = lambda *s, scale=1.0, dtype=torch.bfloat16: (
        scale * torch.randn(s, generator=g, device=dev)).to(dtype).requires_grad_()
    x, f = randn(BATCH, 1024, 32, 32, scale=2.0), randn(BATCH, 2048, scale=0.1)
    w = (1 + 0.1 * torch.randn(1024, generator=g, device=dev)).requires_grad_()
    b = randn(1024, scale=0.1, dtype=torch.float32)

    def gn(fn):
        fs, fb = f.chunk(2, dim=1)
        return fn(x, w, b, act="silu", film_scale=fs, film_shift=fb)

    def fa(dtype):
        q, k, v = (randn(BATCH, 1, 4096, 512, dtype=dtype) for _ in range(3))
        return (f"[{BATCH},1,4096,512]{' fp32' if dtype == torch.float32 else ''}", [q, k, v],
                lambda: attention.multi_head_attention(q, k, v),
                lambda: attention.flash_attention_cuda(q, k, v),
                lambda: attention.attention_plain(q, k, v))

    return [
        ("group_norm", "autograd",
         (f"[{BATCH},1024,32,32] FiLM+SiLU", [x, w, b, f], lambda: gn(group_norm.group_norm),
          lambda: gn(group_norm.group_norm_cuda), lambda: gn(group_norm.group_norm_plain))),
        ("flash_attention", "autograd", fa(torch.bfloat16)),
        ("flash_attention", "autograd_fp32", fa(torch.float32)),
    ]


def autograd_phase(name, case):
    """The kernel's autograd Function against the kernel (forward) and the twin
    (gradients), bit for bit; the backward's CUDA-event time. Returns the
    entry's ``autograd`` block."""
    label, inputs, through, kernel, plain = case
    out = through()
    if out.grad_fn is None or "Function" not in type(out.grad_fn).__name__:
        raise AssertionError(f"{name}: grad-requiring inputs did not go through the Function")
    with torch.no_grad():
        out_k = kernel()
    grad_out = torch.randn(out.shape, generator=torch.Generator(out.device).manual_seed(4),
                           device=out.device).to(out.dtype)
    grads = torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
    ref = torch.autograd.grad(plain(), inputs, grad_out)
    same_out = torch.equal(out, out_k)
    same_grads = all(torch.equal(a, r) for a, r in zip(grads, ref))
    backward_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, grad_out, retain_graph=True),
                          runs=5)
    block = {"shape": label, "function_equals_kernel": same_out,
             "grads_equal_twin_autograd": same_grads, "backward_ms": backward_ms}
    log(f"  {name} autograd {label}: output == kernel {same_out}, gradients == twin's "
        f"{same_grads}; backward (the twin's recompute) {backward_ms:.4f} ms")
    if not (same_out and same_grads):
        raise AssertionError(f"{name}: autograd Function disagrees")
    return block


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


def write_dataset(root, size, pairs, seed, train=2, val=2):
    """A ``custom_aligned`` PNG dataset: ``<stage>/A`` conditions, ``<stage>/B``
    targets (``train``, ``val`` and ``pairs`` test pairs), written by the port."""
    import numpy as np

    from bbdm_tpu_torch.utils.images import to_uint8, write_png

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for stage, n in (("train", train), ("val", val), ("test", pairs)):
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


# ------------------------------------------------------------------- train

TRAIN_PAIRS, VAL_PAIRS, TRAIN_EPOCHS, TRAIN_SAMPLE_INTERVAL = 32, 8, 4, 3


@contextlib.contextmanager
def patched(obj, attr, make):
    """``obj.attr`` replaced by ``make(original)`` for the length of the block."""
    fn = getattr(obj, attr)
    setattr(obj, attr, make(fn))
    try:
        yield
    finally:
        setattr(obj, attr, fn)


def recompute_timer(events):
    """Wrap GroupNormFunction.backward: CUDA events around each call and its
    host seconds, appended to ``events`` as (start, end, host s); the events
    are read after a synchronise (the host does not wait here)."""
    def make(backward):
        def timed_backward(ctx, grad_out):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = backward(ctx, grad_out)
            end.record()
            events.append((start, end, time.perf_counter() - t0))
            return out
        return staticmethod(timed_backward)
    return make


def microbatch_grads(model, runner, batch, t, noise):
    """(loss, gradients of the trainable parameters, None where none arrived)
    of one training microbatch of ``model`` with injected t and noise."""
    model.train()
    x, y = runner._put_batch(batch)
    params = list(model.trainable_parameters().values())
    loss = model.loss(x, y, latent_stats=runner.latent_stats, t=t, noise=noise)[0]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach().float(), grads


def train_phase(dev, counters, root, vqgan_path, gpu_ids="0", config=None, size=None):
    """Drive ``main_torch.main --train`` (see the module docstring, phase 6);
    ``config`` and ``size`` let a CPU rehearsal pass a tiny model."""
    import statistics as st

    import main_torch
    from bbdm_tpu_torch.config import load_config, save_config
    from bbdm_tpu_torch.models.layers import GroupNorm32
    from bbdm_tpu_torch.ops import group_norm
    from bbdm_tpu_torch.profile_slice import measure
    from bbdm_tpu_torch.runners import base
    from bbdm_tpu_torch.training.step import make_train_step

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = config or load_config(os.path.join(here, "configs", "Template-LBBDM-f4.yaml"))
    size = size or cfg.data.dataset_config.image_size
    for name in ("LBBDM-f4.ckpt", "BBDM.ckpt"):  # phase 5's model files: disk for these
        if os.path.exists(os.path.join(root, name)):
            os.remove(os.path.join(root, name))
    data = os.path.join(root, "data-train")
    write_dataset(data, size, BATCH, seed=5, train=TRAIN_PAIRS, val=VAL_PAIRS)
    cfg.data.dataset_config.dataset_path = data
    cfg.model.VQGAN.params.ckpt_path = vqgan_path
    cfg.model.normalize_latent = True
    cfg.model.EMA.start_ema_step, cfg.model.EMA.update_ema_interval = 0, 1
    cfg.model.BB.params.sample_step = SAMPLE_STEP
    cfg.testing.sample_num = 1
    t = cfg.training
    t.sample_interval, t.save_interval = TRAIN_SAMPLE_INTERVAL, TRAIN_EPOCHS
    t.validation_interval = TRAIN_EPOCHS
    path = os.path.join(root, "train.yaml")
    save_config(cfg, path)
    micro = TRAIN_EPOCHS * TRAIN_PAIRS // cfg.data.train.batch_size
    log("reduced: " + json.dumps({
        "n_epochs": {"template": 100, "run": TRAIN_EPOCHS}, "microbatches": micro,
        "train/val/test pairs": [TRAIN_PAIRS, VAL_PAIRS, BATCH],
        "EMA": "from step 0, every update", "sample_step": SAMPLE_STEP,
        "sample_interval": TRAIN_SAMPLE_INTERVAL, "save_interval": TRAIN_EPOCHS,
        "weights": "random UNet (seed), phase 5's VQGAN"}))

    # the training run, counted and timed: each train step's host start time (no
    # added synchronise) and the spans of the steps' neighbours
    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    starts, spans, events = [], [], []

    def timing_step(make):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def timed_step(*sa, **skw):
                starts.append(time.perf_counter())
                return step(*sa, **skw)
            return timed_step
        return wrapped

    def span(fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spans.append((t0, time.perf_counter()))
            return out
        return wrapped

    result = os.path.join(root, "results-train")
    argv = ["-c", path, "--train", "--max_epoch", str(TRAIN_EPOCHS), "-r", result,
            "-s", str(CLI_SEED), "--gpu_ids", gpu_ids]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(base, "make_train_step", timing_step))
        for attr in ("sample_step", "validation_step", "validation_epoch", "_save_checkpoints"):
            stack.enter_context(patched(base.BaseRunner, attr, span))
        stack.enter_context(patched(group_norm.GroupNormFunction, "backward",
                                    recompute_timer(events)))
        runner = main_torch.main(argv)
        torch.cuda.synchronize()
    wall = time.time() - t0
    short = {"group_norm": "K1", "subpixel_upconv": "K2", "flash_attention": "K3"}
    launches = {short[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
    out = {"wall_s": wall, "launches": launches,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    model = runner.model
    n_norms = sum(isinstance(m, GroupNorm32) for m in model.unet.modules())
    out["k1_gradient_recomputes"] = len(events)
    # the span on the card from each recompute's first launch to its last (the
    # card may wait for the host inside it) and the host's time in them
    out["k1_recompute_ms_per_microbatch"] = sum(s.elapsed_time(e) for s, e, _ in events) / micro
    out["k1_recompute_host_ms_per_microbatch"] = sum(h for _, _, h in events) * 1e3 / micro
    clean = [b - a for a, b in zip(starts, starts[1:])
             if not any(a <= s0 < b for s0, _ in spans)]
    out["s_per_microbatch_run"] = st.median(clean[2:]) if len(clean) > 2 else None
    ckpt = runner.config.result.ckpt_path
    out["checkpoints"] = {f: os.path.getsize(os.path.join(ckpt, f))
                          for f in sorted(os.listdir(ckpt))}
    log(f"  train: {wall:.1f} s in main_torch.main ({micro} microbatches), steps "
        f"{runner.global_step}, epoch {runner.global_epoch}, stop {runner.stop_reason}; "
        f"peak device memory {out['peak_memory_gib']:.2f} GiB; launches {launches}; "
        f"K1 gradient recomputes {len(events)} ({n_norms} UNet GroupNorms x {micro}), "
        f"{out['k1_recompute_ms_per_microbatch']:.3f} ms on the card (CUDA-event spans) and "
        f"{out['k1_recompute_host_ms_per_microbatch']:.3f} ms of host time per microbatch; "
        f"median s per "
        f"microbatch in the run (after the first two, sample/validation/save steps out) "
        f"{out['s_per_microbatch_run']}; checkpoints {out['checkpoints']}")
    if runner.global_step != micro or len(events) != n_norms * micro:
        raise AssertionError("train: wrong step count or not every UNet GroupNorm went "
                             "through GroupNormFunction")
    expected = {"config.yaml", "last_model.ckpt", "last_optim_sche.ckpt",
                f"latest_model_{TRAIN_EPOCHS}.ckpt", f"latest_optim_sche_{TRAIN_EPOCHS}.ckpt"}
    if set(out["checkpoints"]) != expected:
        raise AssertionError(f"train: checkpoint files {sorted(out['checkpoints'])}")
    if sorted(os.listdir(runner.config.result.image_path)) != [
            str(TRAIN_SAMPLE_INTERVAL * TRAIN_PAIRS // cfg.data.train.batch_size)]:
        raise AssertionError("train: not one mid-training sample")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"train: kernels {missing} were not launched")

    # seconds per microbatch and per optimizer update in a loop like the runner's
    # (the previous loss read after queueing each step), two update cycles
    acc = int(cfg.training.accumulate_grad_batches)
    step = make_train_step(model, cfg.training, cfg.model.EMA, runner.lr_scheduler_config)
    batch = next(iter(runner._build_loaders()[0]))
    x, y = runner._put_batch(batch)
    model.train()

    def microbatches(n):
        prev = None
        for _ in range(n):
            metrics = step(runner.state, x, y, runner.train_generator)
            if prev is not None:
                float(prev["loss"])
            prev = metrics
        float(prev["loss"])

    while runner.state.step % acc:
        microbatches(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    microbatches(2 * acc)
    torch.cuda.synchronize()
    loop = time.perf_counter() - t0
    out["s_per_microbatch"], out["s_per_update"] = loop / (2 * acc), loop / 2
    wall_ms, busy_ms, _ = measure(lambda: microbatches(2), 1, 2)
    out["microbatch_wall_ms"], out["microbatch_device_busy_ms"] = wall_ms, busy_ms
    out["idle_share"] = 1 - busy_ms / wall_ms
    log(f"  train loop: {out['s_per_microbatch']:.4f} s per microbatch, "
        f"{out['s_per_update']:.4f} s per optimizer update ({acc} microbatches); over two "
        f"microbatches wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms per microbatch, "
        f"idle share {out['idle_share']:.0%}")

    # one microbatch through the kernels against the twins (bf16, fp32), same
    # weights, batch, t and noise
    g = torch.Generator(runner.device).manual_seed(6)
    zshape = model.encode(x).shape
    tt = torch.randint(0, model.num_timesteps, (x.shape[0],), generator=g, device=x.device)
    noise = torch.randn(zshape, generator=g, device=x.device)
    loss_k, grads_k = microbatch_grads(model, runner, batch, tt, noise)
    absent = [n for n, gr in zip(model.trainable_parameters(), grads_k) if gr is None]
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads_k if gr is not None)
    vq_free = all(p.grad is None and not p.requires_grad for p in model.vqgan.parameters())
    with plain_ops():
        loss_p, grads_p = microbatch_grads(model, runner, batch, tt, noise)
        ref32 = build_fp32_copy(cfg.model, model, runner.device)
        loss_32, grads_32 = microbatch_grads(ref32, runner, batch, tt, noise)
        del ref32
    model.eval()
    flat = lambda gs: torch.cat([gr.float().flatten() for gr in gs])
    d = lambda a, b: float((a - b).abs().max())
    gk, gp, g32 = flat(grads_k), flat(grads_p), flat(grads_32)
    out.update(loss_kernel_vs_plain=d(loss_k, loss_p), loss_bf16_vs_fp32=d(loss_p, loss_32),
               grad_kernel_vs_plain=d(gk, gp), grad_bf16_vs_fp32=d(gp, g32),
               grad_max_abs=float(g32.abs().max()), loss=float(loss_k),
               trainable_grads=len(grads_k), absent_grads=len(absent), finite_grads=finite,
               vqgan_without_grad=vq_free)
    log("  train microbatch, kernels vs twins: " + json.dumps(
        {k: out[k] for k in ("loss", "loss_kernel_vs_plain", "loss_bf16_vs_fp32",
                             "grad_kernel_vs_plain", "grad_bf16_vs_fp32", "grad_max_abs",
                             "trainable_grads", "absent_grads", "finite_grads",
                             "vqgan_without_grad")}))
    if absent or not finite or not vq_free:
        raise AssertionError(f"train: gradients absent {absent[:3]}, finite {finite}, "
                             f"VQGAN without gradient {vq_free}")
    for what in ("loss", "grad"):
        if out[f"{what}_kernel_vs_plain"] > 2 * out[f"{what}_bf16_vs_fp32"]:
            raise AssertionError(f"train: {what} through the kernels farther from the twins "
                                 "than 2x bf16 error")

    # the trained last_model.ckpt samples through the CLI
    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    sampled = main_torch.main(["-c", path, "--sample_to_eval", "--resume_model",
                               os.path.join(ckpt, "last_model.ckpt"), "-r",
                               os.path.join(root, "results-trained-sample"), "-s",
                               str(CLI_SEED), "--gpu_ids", gpu_ids])
    names = [f"{i:04d}" for i in range(BATCH)]
    check_tree(sampled.config.result.sample_to_eval_path, names, names, SAMPLE_STEP, 1, size)
    if (sampled.global_epoch, sampled.global_step) != (TRAIN_EPOCHS, micro):
        raise AssertionError("trained checkpoint: epoch and step not read")
    out["sample_launches"] = {short[k]: getattr(mod, attr).launches
                              for k, (mod, attr) in counters.items()}
    log(f"  trained last_model.ckpt sampled through --sample_to_eval: {BATCH} PNGs, launches "
        f"{out['sample_launches']}")
    return out


# -------------------------------------------------------------- VQGAN train

VQ_COUNTS, VQ_EPOCHS, VQ_SAMPLE_INTERVAL = (16, 8, 8), 2, 1.5
# phase 7's bars on the kernels-vs-twins distance of one VQGAN step, each near
# the geometric mean of the largest distance the kernels gave and the smallest
# TF32 gave over five runs on an H100 (PERF.md §6, VQGAN training), about 3x from
# either; the twins' own run-to-run distance is 0 forward and < 1e-6 in the
# gradients. d_weight and disc_loss are printed with no bar: TF32 moved them
# no more than the kernels did in some runs (d_weight 9.7e-5 against 7.3e-5),
# and what they do to the step is in gen_grad and disc_grad
VQ_STEP_BARS = {"norm_rel": {"xrec": 6e-5, "gen_loss": 1e-5, "gen_grad": 7e-4,
                             "disc_grad": 3.5e-3}}


def write_single_dataset(root, size, counts, seed):
    """A ``custom_single`` PNG dataset: ``<stage>/<i>.png`` for the (train, val,
    test) ``counts``, written by the port."""
    import numpy as np

    from bbdm_tpu_torch.utils.images import to_uint8, write_png

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for stage, n in zip(("train", "val", "test"), counts):
        os.makedirs(os.path.join(root, stage), exist_ok=True)
        for i in range(n):
            smooth = np.sin(6 * yy[..., None] + 4 * xx[..., None] + rs.uniform(0, 2 * np.pi, 3))
            img = smooth + rs.uniform(-0.2, 0.2, (size, size, 3))
            write_png(os.path.join(root, stage, f"{i:04d}.png"), to_uint8(np.clip(img, -1, 1)))


@contextlib.contextmanager
def tf32():
    """TF32 in cuDNN convolutions and cuBLAS matmuls for the length of the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def gan_step_grads(runner, x, loss_config):
    """One VQGAN step without an update: ({"xrec", "gen_loss", "d_weight",
    "disc_loss", "gen_grad", "disc_grad"}, the gradients flattened, and the
    gradients of both players' parameters, None where none reached one); the
    BatchNorm statistics the discriminator term moves are put back."""
    from bbdm_tpu_torch.training.gan import make_vqgan_losses

    vq, disc = runner.model.vqgan, runner.model.discriminator
    saved = {k: b.clone() for k, b in disc.named_buffers()}
    gen_loss, disc_loss = make_vqgan_losses(vq, disc, loss_config)
    step = runner.state.step + 1
    total, aux = gen_loss(x, step)
    g = torch.autograd.grad(total, list(vq.parameters()), allow_unused=True)
    d = disc_loss(x, aux["xrec"].detach(), step)
    dg = torch.autograd.grad(d, list(disc.parameters()), allow_unused=True)
    with torch.no_grad():
        for k, b in disc.named_buffers():
            b.copy_(saved[k])
    flat = lambda gs: torch.cat([gr.float().flatten() for gr in gs if gr is not None])
    values = {"xrec": aux["xrec"].detach(), "gen_loss": total.detach(),
              "d_weight": aux["d_weight"], "disc_loss": d.detach(), "gen_grad": flat(g),
              "disc_grad": flat(dg)}
    return values, list(g) + list(dg)


def vqgan_train_phase(dev, counters, root, gpu_ids="0", config=None, lbbdm_config=None):
    """Drive ``main_torch.main --train`` with ``runner: VQGANRunner`` (see the
    module docstring, phase 7); ``config`` and ``lbbdm_config`` let a CPU
    rehearsal pass tiny models."""
    import statistics as st

    import main_torch
    from bbdm_tpu_torch.config import load_config, save_config
    from bbdm_tpu_torch.profile_slice import measure
    from bbdm_tpu_torch.runners import base
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner
    from bbdm_tpu_torch.runners.vqgan import VQGANRunner

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = config or load_config(os.path.join(here, "configs", "Template-VQGAN-f4.yaml"))
    size = cfg.data.dataset_config.image_size
    data = os.path.join(root, "data-vqgan")
    write_single_dataset(data, size, VQ_COUNTS, seed=7)
    cfg.data.dataset_config.dataset_path = data
    cfg.data.dataset_config.flip = False  # flip doubles the train set: 4 steps, not 8
    loss = cfg.model.loss
    loss.disc_start, loss.perceptual_weight, loss.lpips_weights = 0, 0.0, None
    t = cfg.training
    t.save_interval = t.validation_interval = VQ_EPOCHS
    t.sample_interval = VQ_SAMPLE_INTERVAL
    path = os.path.join(root, "vqgan.yaml")
    save_config(cfg, path)
    steps = VQ_EPOCHS * VQ_COUNTS[0] // cfg.data.train.batch_size
    log("reduced: " + json.dumps({
        "n_epochs": {"template": 100, "run": VQ_EPOCHS}, "steps": steps,
        "train/val/test images": list(VQ_COUNTS), "flip": {"template": True, "run": False},
        "disc_start": {"template": 30000, "run": 0},
        "perceptual_weight": {"template": 1.0, "run": 0.0, "lpips_weights": None},
        "sample_interval": VQ_SAMPLE_INTERVAL, "save_interval": VQ_EPOCHS,
        "weights": "random (seed)"}))

    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    starts, spans = [], []

    def timing_build(build):
        def wrapped(self):
            step = build(self)

            def timed_step(*a, **kw):
                starts.append(time.perf_counter())
                return step(*a, **kw)
            return timed_step
        return wrapped

    def span(fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spans.append((t0, time.perf_counter()))
            return out
        return wrapped

    argv = ["-c", path, "--train", "--max_epoch", str(VQ_EPOCHS), "-r",
            os.path.join(root, "results-vqgan"), "-s", str(CLI_SEED), "--gpu_ids", gpu_ids]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(VQGANRunner, "build_train_step", timing_build))
        for attr in ("sample_step", "validation_step", "validation_epoch", "_save_checkpoints"):
            stack.enter_context(patched(base.BaseRunner, attr, span))
        runner = main_torch.main(argv)
        torch.cuda.synchronize()
    wall = time.time() - t0
    short = {"group_norm": "K1", "subpixel_upconv": "K2", "flash_attention": "K3"}
    launches = {short[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
    ckpt = runner.config.result.ckpt_path
    clean = [b - a for a, b in zip(starts, starts[1:])
             if not any(a <= s0 < b for s0, _ in spans)]
    out = {"wall_s": wall, "launches": launches, "steps": runner.global_step,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "s_per_step_run": st.median(clean) if clean else None,
           "checkpoints": {f: os.path.getsize(os.path.join(ckpt, f))
                           for f in sorted(os.listdir(ckpt))}}
    count = lambda m: sum(p.numel() for p in m.parameters())
    out["params"] = {"vqgan": count(runner.model.vqgan),
                     "discriminator": count(runner.model.discriminator)}
    log(f"  vqgan train: {wall:.1f} s in main_torch.main ({steps} steps), steps "
        f"{runner.global_step}, epoch {runner.global_epoch}; parameters {out['params']}; peak "
        f"device memory {out['peak_memory_gib']:.2f} GiB; launches {launches}; median s per "
        f"step between plain steps {out['s_per_step_run']}; checkpoints {out['checkpoints']}")
    if runner.global_step != steps:
        raise AssertionError("vqgan train: wrong step count")
    expected = {"config.yaml", "last_model.ckpt", "last_optim_sche.ckpt",
                f"latest_model_{VQ_EPOCHS}.ckpt", f"latest_optim_sche_{VQ_EPOCHS}.ckpt"}
    if set(out["checkpoints"]) != expected:
        raise AssertionError(f"vqgan train: checkpoint files {sorted(out['checkpoints'])}")
    grids = os.listdir(runner.config.result.image_path)
    if len(grids) != 1 or sorted(os.listdir(os.path.join(
            runner.config.result.image_path, grids[0], "train_sample"))) != [
            "input.png", "reconstruction.png"]:
        raise AssertionError(f"vqgan train: not one sample grid ({grids})")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"vqgan train: kernels {missing} were not launched")

    # seconds per step in a loop like the runner's (the previous loss read
    # after queueing each step); the idle share over two steps
    step = runner.build_train_step()
    x, _ = runner._put_batch(next(iter(runner._build_loaders()[0])))
    runner.model.train()

    def run_steps(n):
        prev = None
        for _ in range(n):
            metrics = step(runner.state, x, x, runner.train_generator)
            if prev is not None:
                float(prev["loss"])
            prev = metrics
        float(prev["loss"])

    run_steps(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(4)
    torch.cuda.synchronize()
    out["s_per_step"] = (time.perf_counter() - t0) / 4
    wall_ms, busy_ms, dev_ms = measure(lambda: run_steps(2), 1, 2)
    out["step_wall_ms"], out["step_device_busy_ms"] = wall_ms, busy_ms
    out["idle_share"] = 1 - busy_ms / wall_ms
    out["step_device_ms_top"] = dict(sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8])
    out["k3_device_ms_per_step"] = sum(v for k, v in dev_ms.items()
                                       if "flash_attention_f32_kernel" in k)
    log(f"  vqgan train loop: {out['s_per_step']:.4f} s per step (batch "
        f"{x.shape[0]}, both players); over two steps wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms per step, idle share {out['idle_share']:.0%}; top device ms "
        + json.dumps({k[:60]: round(v, 3) for k, v in out["step_device_ms_top"].items()}))
    log(f"  vqgan step summary: {out['s_per_step']:.4f} s per step, device busy "
        f"{busy_ms:.1f} ms, idle share {out['idle_share']:.1%}, peak device memory "
        f"{out['peak_memory_gib']:.2f} GiB, K3 fp32 (3xTF32, pre-pass included) "
        f"{out['k3_device_ms_per_step']:.3f} device ms per step")

    # one step through the kernels against the same step through the twins
    # (fp32 both, same weights, batch and BatchNorm statistics); the twins once
    # more as they were (the floor: how far two runs of the same fp32 code
    # differ on the card) and once with TF32 convolutions and matmuls (10 bits
    # of mantissa), which each bar must refuse. The twins' runs take the codes
    # the kernels' run chose: a near tie between two codes that another
    # summation order breaks the other way moves the reconstruction there by
    # the distance between the two codes, far beyond any rounding, so the codes
    # that differ are counted and the bars hold what the kernels compute
    quantize = runner.model.vqgan.quantize
    codes, code_flips = [], []

    def record(nearest):
        return lambda z: codes.append(nearest(z)) or codes[0]

    def pin(nearest):
        return lambda z: code_flips.append(int((nearest(z) != codes[0]).sum())) or codes[0]

    with patched(quantize, "nearest", record):
        kern, grads = gan_step_grads(runner, x, loss)
    with plain_ops(), patched(quantize, "nearest", pin):
        twin, _ = gan_step_grads(runner, x, loss)
        twin2, _ = gan_step_grads(runner, x, loss)
        with tf32():
            twin_tf32, _ = gan_step_grads(runner, x, loss)
    del quantize.nearest  # the class's method again
    out["code_flips"] = dict(zip(("twin", "twin2", "tf32"), code_flips), of=codes[0].numel())
    runner.model.eval()
    params = list(runner.model.vqgan.named_parameters()) + list(
        runner.model.discriminator.named_parameters())
    absent = [n for (n, _), gr in zip(params, grads) if gr is None]
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads if gr is not None) and all(
        bool(torch.isfinite(p).all()) for _, p in params)
    out.update(gen_loss=float(kern["gen_loss"]), d_weight=float(kern["d_weight"]),
               disc_loss=float(kern["disc_loss"]), trainable=len(params),
               absent_grads=len(absent), finite=finite)
    # each as the largest difference over the twins' largest element, and as
    # the norm of the difference over the twins' norm
    metrics = {"max_rel": lambda a, b: float((a - b).abs().max() / b.abs().max()),
               "norm_rel": lambda a, b: float((a - b).norm() / b.norm())}
    dist = lambda a: {m: {k: f(a[k], twin[k]) for k in twin} for m, f in metrics.items()}
    out["kernel_vs_twin"], out["twin_vs_twin"], out["tf32_vs_twin"] = (
        dist(kern), dist(twin2), dist(twin_tf32))
    out["bar"] = VQ_STEP_BARS
    log("  vqgan step, kernels vs twins: " + json.dumps(
        {k: out[k] for k in ("gen_loss", "d_weight", "disc_loss", "code_flips",
                             "kernel_vs_twin", "twin_vs_twin", "tf32_vs_twin", "bar",
                             "trainable", "absent_grads", "finite")}))
    if absent or not finite:
        raise AssertionError(f"vqgan step: gradients absent {absent[:3]}, finite {finite}")
    if out["d_weight"] <= 0:
        raise AssertionError("vqgan step: the adaptive d_weight is not live")
    bars = [(m, k, b) for m, per in VQ_STEP_BARS.items() for k, b in per.items()]
    log(f"  vqgan step: codes the kernels pick differently from the twins: "
        f"{out['code_flips']['twin']} of {out['code_flips']['of']}")
    for m, k, b in bars:
        log(f"  vqgan step {m} {k}: kernels {out['kernel_vs_twin'][m][k]:.3e}, twins again "
            f"{out['twin_vs_twin'][m][k]:.3e}, TF32 {out['tf32_vs_twin'][m][k]:.3e}; bar {b:g} "
            f"(kernels at {out['kernel_vs_twin'][m][k] / b:.2f} of it, TF32 at "
            f"{out['tf32_vs_twin'][m][k] / b:.1f}x)")
    checks = {"the twins' floor above the bar": [
                  f"{m} {k}" for m, k, b in bars if not out["twin_vs_twin"][m][k] <= b],
              "TF32 within the bar": [
                  f"{m} {k}" for m, k, b in bars if not out["tf32_vs_twin"][m][k] > b],
              "kernels farther from the twins than the bar": [
                  f"{m} {k}" for m, k, b in bars if not out["kernel_vs_twin"][m][k] <= b]}
    failed = {what: keys for what, keys in checks.items() if keys}
    if failed:
        raise AssertionError(f"vqgan step: {failed}")

    # the trained checkpoint reconstructs the test set through --sample_to_eval
    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    last = os.path.join(ckpt, "last_model.ckpt")
    sampled = main_torch.main(["-c", path, "--sample_to_eval", "--resume_model", last, "-r",
                               os.path.join(root, "results-vqgan-sample"), "-s",
                               str(CLI_SEED), "--gpu_ids", gpu_ids])
    out["sample_launches"] = {short[k]: getattr(mod, attr).launches
                              for k, (mod, attr) in counters.items()}
    tree = sampled.config.result.sample_to_eval_path
    names = sorted(f"{i:04d}.png" for i in range(VQ_COUNTS[2]))
    for sub in ("reconstruction", "ground_truth"):
        if sorted(os.listdir(os.path.join(tree, sub))) != names:
            raise AssertionError(f"vqgan sample_to_eval: {sub} holds "
                                 f"{sorted(os.listdir(os.path.join(tree, sub)))}")
    check_png(os.path.join(tree, "reconstruction", names[0]), size, size)
    if (sampled.global_epoch, sampled.global_step) != (VQ_EPOCHS, steps):
        raise AssertionError("vqgan checkpoint: epoch and step not read")
    if out["sample_launches"]["K2"] <= 0:
        raise AssertionError("vqgan sample_to_eval: K2 (fp32) was not launched")
    log(f"  trained VQGAN last_model.ckpt reconstructed through --sample_to_eval: "
        f"{len(names)} PNGs, launches {out['sample_launches']}")

    # that checkpoint as an LBBDM-f4 first stage: one encode and decode
    lcfg = lbbdm_config or load_config(os.path.join(here, "configs",
                                                    "Template-LBBDM-f4.yaml"))
    lcfg.model.VQGAN.params.ckpt_path = last
    lb = BBDMRunner(lcfg, device=runner.device, seed=0)
    same = all(torch.equal(a, b) for a, b in zip(lb.model.vqgan.state_dict().values(),
                                                   sampled.model.vqgan.state_dict().values()))
    z = lb.model.encode(x)
    img = lb.model.decode(z)
    torch.cuda.synchronize()
    out["lbbdm_first_stage"] = {"weights_equal": same, "latent": list(z.shape),
                                "image": list(img.shape),
                                "finite": bool(torch.isfinite(img).all())}
    log(f"  as an LBBDM first stage: {json.dumps(out['lbbdm_first_stage'])}")
    if not (same and out["lbbdm_first_stage"]["finite"]
            and tuple(img.shape) == tuple(x.shape)):
        raise AssertionError("the trained VQGAN does not load as an LBBDM first stage")
    del lb, runner, sampled
    return out


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
    for name, route, sources, replaces, counter, patterns, cases in kernel_cases(dev):
        counters[name] = counter
        try:
            t0 = time.time()
            e = kernel_phase(name, counter, patterns, cases)
            log(f"kernel {name}: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append(name)
            e = {}
        entries.append({"name": name, "route": route, "source": sources[0],
                        "sources": sources, "replaces": replaces, "launches": 0, **e})
        torch.cuda.empty_cache()
    for name, key, case in autograd_cases(dev):
        try:
            block = autograd_phase(name, case)
        except Exception:
            traceback.print_exc()
            failed.append(f"{name} {key}")
            block = {}
        next(e for e in entries if e["name"] == name)[key] = block
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

    cli, train, vqgan = {}, {}, {}
    short = {"group_norm": "K1", "subpixel_upconv": "K2", "flash_attention": "K3"}
    for e in entries:
        e["launches_by_path"] = {"slice_sample_to_eval": e["launches"]}
    with tempfile.TemporaryDirectory(prefix="bbdm_smoke_cli_") as root:
        try:
            t0 = time.time()
            by_path, cli = cli_phase(dev, counters, root)
            for e in entries:
                e["launches_by_path"].update({p: n[short[e["name"]]] for p, n in by_path.items()})
            log(f"cli: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("cli")
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            train = train_phase(dev, counters, root, os.path.join(root, "LBBDM-f4-vqgan.ckpt"))
            for e in entries:
                e["launches_by_path"]["train"] = train["launches"][short[e["name"]]]
            log(f"train: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("train")
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            vqgan = vqgan_train_phase(dev, counters, root)
            for e in entries:
                e["launches_by_path"]["vqgan_train"] = vqgan["launches"][short[e["name"]]]
                e["launches_by_path"]["vqgan_sample_to_eval"] = \
                    vqgan["sample_launches"][short[e["name"]]]
            log(f"vqgan train: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("vqgan train")

    log(json.dumps({"kernels": entries, "slice": timings, "cli": cli, "train": train,
                    "vqgan_train": vqgan, "card": card}))
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
