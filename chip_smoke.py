#!/usr/bin/env python3
"""Check the PyTorch port (``bbdm_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

The smoke checks; it does not measure speed, which the benchmark's cells do
(``benchmark/run.py``). Phase 3's table of kernel times is the exception: it
is the port's only per-kernel timing on the card. Each phase ends in a line
``<phase>: ok (N s)``. Phases, each of which must pass:

1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, TF32 off;
2. build: nvcc of ``bbdm_tpu_torch/csrc/*.cu`` for sm_90a, g++ of the host
   image library (``native/``);
3. kernels: each hand-written kernel (K1 GroupNorm, K2 subpixel up-conv, K3
   flash attention, all CUDA C++; K2 and K3 in bf16 and, from their
   ``*_f32.cu`` sources, in fp32) against its plain PyTorch twin, one launch a
   call, at the shapes the LBBDM-f4 path (bf16) and VQGAN-f4 training (fp32)
   give it, at phase 9's (f16's 4^2 and 8^2 UNet levels, f8's VQGAN attention
   at T=1024, the transformer's eps-1e-6 norms), K3 with keys != queries (Tk
   4096 and 1 for 1024 queries), at the SD v1 UNet's heads (D 40, 80, 160) and
   at edge cases. The fp32 K2 and K3 compute in 3xTF32: at each of their path
   shapes the function with one TF32 pass (``ops.tf32_round`` inputs) must
   miss the bar the kernel meets. At the path shapes it also times the kernel
   (CUDA events, wrapper included), its twin and one PyTorch library call
   computing the same function (K1: a subset of it), and reads the kernel's
   own device time (torch.profiler), K3's SDPA backends and the bound: the
   larger of the kernel's bytes over 3.35 TB/s and its operations over the
   peak rate for their type (H100 SXM data sheet; the fp32 K2 and K3 at three
   TF32 passes at 495 TFLOP/s, the same work as fp32 FMAs at 67 TFLOP/s
   beside it). K1 (UNet shape, FiLM + SiLU) and K3 (the VQGAN attention, bf16
   and fp32) also go through their autograd Functions: the output equal to
   the kernel's, K1's gradients (its backward kernel) within
   :func:`k1_grad_excess`'s bars of the twin's and equal to themselves on a
   second call, K3's equal to the twin's bit for bit (its backward is that
   recompute); the backward's time is printed;
4. slice: LBBDM-f4 at full width (VQGAN ch 128 x (1,2,4) at 256^2, UNet mc
   128 x (1,4,8) at 64^2, bf16, batch 8, seeded random weights), 20 sampling
   steps, 2 draws: the encode and the sampled latent through the kernels
   within twice the twins' bf16-vs-fp32 distance of the twins' (same weights
   and noise) and not equal to them, a finite latent and image of the right
   shape; then ``BBDMRunner.sample_to_eval`` over 2 synthetic batches: its
   output tree, every kernel launched;
5. CLI: ``main_torch.main`` on synthetic ``custom_aligned`` PNG datasets (8
   test pairs, 256^2 for LBBDM-f4, 64^2 for pixel BBDM), text copies of
   ``configs/Template-{LBBDM-f4,BBDM}.yaml`` cut to 20 steps, checkpoints
   whose ``model`` and ``ema`` weights differ: LBBDM-f4 euler
   ``--sample_to_eval`` (2 draws) and heun, BBDM grid mode and
   ``--sample_to_eval``: each output tree, the checkpoint's epoch and step
   read, the kernels each path needs launched; the euler run within 1 uint8
   level of an in-process ``BBDMRunner`` with the same EMA weights and seed;
   heun's latent through the kernels within twice the twins' bf16-vs-fp32
   distance of the twins' (same noise) and not equal to it;
6. training: ``main_torch.main --train`` of ``Template-LBBDM-f4.yaml`` at full
   width (batch 8, ``accumulate_grad_batches`` 4) on a synthetic 256^2
   dataset (32 train, 8 val, 8 test pairs) with phase 5's VQGAN, 4 epochs (16
   microbatches), ``normalize_latent``, an EMA from step 0 and one
   mid-training sample: the step count, the checkpoint files, the one
   sample, every kernel launched, every UNet GroupNorm through
   ``GroupNormFunction`` with one launch of K1's backward each; one
   microbatch through the kernels within twice the twins' bf16-vs-fp32
   distance of the twins' (loss and flattened gradient), every trainable
   gradient present and finite, the VQGAN without one; ``--sample_to_eval``
   from the trained ``last_model.ckpt``: its tree, its epoch and step;
7. VQGAN training: ``main_torch.main --train`` of ``Template-VQGAN-f4.yaml``
   at full width (fp32, batch 8, PatchGAN ndf 64 x 3) with ``disc_start`` 0
   and no perceptual term on a synthetic 256^2 ``custom_single`` dataset (16
   train, 8 val, 8 test images), 2 epochs (4 steps), one sample grid, one
   validation and one save: the step count, the checkpoint files, the grid,
   every kernel launched; one step through the kernels against the twins
   with the kernels' codes: reconstruction, generator loss, generator and
   discriminator gradients within the fixed ``VQ_STEP_BARS``, which the twins
   run twice must pass and the twins with TF32 must fail; d_weight live;
   every parameter of both players with a finite gradient; then
   ``--sample_to_eval`` from its ``last_model.ckpt`` (the tree, K2 launched)
   and that file as an LBBDM-f4 first stage (its weights, a finite encode and
   decode). A second run trains 2 steps with ``perceptual_weight`` 1.0 and
   seeded random LPIPS-VGG weights written as a ``.pth``: the steps, every
   kernel launched, a checkpoint without the LPIPS weights, every gradient of
   a step present and finite and none reaching LPIPS, the LPIPS term at
   [8,3,256,256] on the card within 1e-4 relative of the CPU's;
8. evaluation: ``preprocess_and_evaluation_torch.py`` (in process, and once
   as its own process) over phase 5's euler tree with smoke-made random
   InceptionV3 and LPIPS alex and vgg weights: every ``-f`` mode on the card
   against ``--cpu``: the same files (rename_samples, copy_samples), LPIPS
   and max_min_LPIPS within 1e-5 relative, diversity and PSNR/SSIM printed
   alike, every value finite; the script's own process's LPIPS; the pool3
   features within 1e-4 and the per-pair LPIPS distances within 1e-5
   relative of the CPU's;
9. latent paths: ``Template-LBBDM-f8.yaml``, ``Template-LBBDM-f16.yaml`` and
   ``Template-LBBDM-f4.yaml`` with the cross-attention UNet
   (:func:`path_configs`) through ``main_torch.main`` at full width from
   seeded random weights, ``PATH_STEP`` steps and 1 draw: a
   ``--sample_to_eval`` batch of 8 and a one-epoch ``--train`` run, each
   run's K1/K2/K3 launches (and K1's backward launches) equal to the counts
   :func:`kernel_calls` derives from the modules walked on the meta device;
   the tree, the step count, the checkpoint files; the encode and the
   sampled latent through the kernels within twice the twins' bf16-vs-fp32
   distance; every trainable gradient present and finite;
10. data parallelism (``parallel/``): (a) LBBDM-f4 training (8 microbatches,
   2 updates) as 1 rank, as 2 gloo ranks sharing card 0 and as 1 rank in
   fp32 through the twins: each rank's launches as :func:`kernel_calls`
   derives, the 2 ranks' lr and losses those of 1, the parameters, update
   and losses no farther from 1 rank's than twice the fp32 run's distance;
   (b) ``--sample_to_eval`` the same three ways: the same files, the copied
   inputs equal, the samples' mean uint8 distance from 1 rank's within twice
   the fp32 run's, the launches; (c) VQGAN-f4 training in fp32, 2 steps, 1
   and 2 ranks with the 1-rank run's codes pinned: losses, d_weight,
   BatchNorm statistics and first-step gradients within ``VQ_STEP_BARS``,
   the parameters within Adam's bar; (d) ``main_torch.main`` ``--train`` and
   ``--sample_to_eval`` on a cut LBBDM-f4 as one NCCL node of one rank
   (``BBDM_MULTIHOST``): the backend, the checkpoint files and keys of the
   same run without a process group, the kernels launched; (e) that plain
   run's ``training.profile_dir``: one chrome trace, naming K1 and K3;
11. FSDP and tensor parallelism (``training.fsdp``,
   ``training.model_parallel``), 2 gloo ranks on card 0 against 1 rank and 1
   rank in fp32 through the twins: (a) LBBDM-f4 training under ``fsdp`` on a
   2 x 1 grid and (b) under ``model_parallel: 2`` on a 1 x 2 grid: each
   rank's launches, lr and losses as 1 rank's, the losses and parameters
   within twice the fp32 run's distance, each rank's train-state bytes (at
   most 0.55 of one rank's under ``fsdp``), ``memory_allocated`` and peak;
   (c) VQGAN-f4 in fp32 under each, against 1 rank with its codes pinned,
   with phase 10 (c)'s bars; (d) ``--sample_to_eval`` from (a)'s checkpoint
   on the 1 x 2 grid, phase 10 (b)'s rule;
12. the data layer (``data/``, ``utils/images.py``, ``native/``): (a) every
   committed fixture of ``tests/data/torch_images/`` and of its ``webp/``
   decoded equal to its stored array or digest (Pillow's RGB, OpenCV's LAB
   and ``cv2.imread``'s reading, EXIF orientation and 16-bit gray included);
   (b) ``main_torch.main --train`` of LBBDM-f4 on a 256^2 tree of
   Paeth-filtered PNGs as ``custom_inpainting`` with ``cache_in_ram`` and
   flip, 2 epochs of 16 microbatches: the launches as :func:`kernel_calls`
   derives, the step count, one validation, 128 image decodes in the first
   epoch and none in the second, every served train item's box the numpy
   rule's for its epoch's seed; (c) ``--sample_to_eval`` from that checkpoint
   over a ``custom_colorization_LAB`` tree of the JPEG fixtures and over a
   ``custom_aligned`` tree of VP8 q85 pairs: each tree and its launches; (d)
   ``training.device_data_cache`` (:func:`device_cache_checks`) on (b)'s
   runner: the cached batches equal to ``_put_batch`` of the host loader's
   bit for bit over an epoch, the latent statistics from the resident copy
   within 1e-5 of the host loader's, then one epoch of ``BaseRunner.train``
   through the host loader and one through the cache: each epoch's steps and
   launches, the caches built and logged (none, then train and val);
13. the tools (``bbdm_tpu_torch/tools``): (a) ``bench_torch.py`` as its own
   process at the full width of ``Template-LBBDM-f4.yaml`` (batch 8, 200
   euler steps) and (b) with heun at 20 steps: ``flops_per_sample`` the
   port's ``sampling_flops_per_image``, a finite output, the launches of its
   4 calls; (c) ``tools.bench_train`` (11 train steps: the launches, a finite
   loss, ``flops_per_image``); (d) none for ``tools.convert_checkpoint``,
   host code that launches no kernel; (e) ``tools.vqgan_recon`` over phase
   5's ground truth in bf16 and ``--fp32``: the launches, K2 and K3 all in
   the dtype asked for, PSNR/SSIM finite; (f) ``tools.sampler_sweep`` with
   two variants: each report's ``nfe``, the launches, a second invocation
   that skips both and launches nothing; (g) ``q_sample_loop`` over 1000 steps
   at the f4 latent of batch 8 in bf16 within 2^-7 of |x0| + |y| + sigma_t
   |noise| of its fp32 self (twice the bound of the inputs' bf16 rounding);
   (h) ``BERTEmbedder`` at LDM txt2img-1.4B's width (1280 x 32) on [8, 77]
   tokens from the port's ``BERTTokenizer``, bf16 within 3e-2 relative
   (Frobenius) of fp32;
14. the demonstrations (``tools``) as users run them, on ``tools.synthetic``
   trees of 16 train, 8 val and 8 test pairs: (a) ``tools.chain_demo`` at
   full width (2 s training budgets, phase C at 200 steps, phase D at 5
   draws), (b) ``tools.pixel_demo`` (one epoch, phase E, phase S
   ``euler:20,heun:10``), (c) ``tools.stochastic_demo`` (one epoch, then
   ``euler:20`` at 2 draws): each part's launches equal to the counts
   :func:`kernel_calls` derives, its reports, the device caches its configs
   ask for built and logged; (d) ``tools.read_tboard``'s rows equal to every
   scalar the runners logged; (e) ``tools.run_parity`` on (a)'s bridge written
   as a reference ``.pth``: its samples within 1 uint8 level of (a)'s phase C,
   LPIPS present.

Prints the kernels' JSON line (each kernel's errors and sums over its timed
shapes for the 16-bit cases at the top of its entry, for the fp32 cases in
its ``fp32`` block), then as its last line ``{"ok": true, "device": {...}}``;
exits non-zero, without that line, when a phase fails, when there is no CUDA
card, or when run outside a checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import torch

SAMPLE_STEP, SAMPLE_NUM, BATCHES, BATCH = 20, 2, 2, 8
CLI_TEST_PAIRS, CLI_SEED = 8, 1234  # 16 before PR 15's phase 14
SHORT = {"group_norm": "K1", "subpixel_upconv": "K2", "flash_attention": "K3"}


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
    length of the block (the package itself never sends a CUDA tensor there).
    The sampler's steps run eagerly in the block: a step captured earlier as
    a CUDA graph would replay the kernels, whatever the ops are routed to."""
    from bbdm_tpu_torch.models import bridge
    from bbdm_tpu_torch.ops import attention, group_norm, upsample_conv

    saved = (group_norm.group_norm, upsample_conv.upsample2x_conv3x3,
             attention.multi_head_attention, bridge._graph_steps)
    group_norm.group_norm = group_norm.group_norm_plain
    upsample_conv.upsample2x_conv3x3 = (
        lambda x, w, b, *, dtype=None, combined=None:
        upsample_conv.upsample_conv_plain(x, w, b, dtype=dtype))
    attention.multi_head_attention = attention.attention_plain
    bridge._graph_steps = lambda y: False
    try:
        yield
    finally:
        (group_norm.group_norm, upsample_conv.upsample2x_conv3x3,
         attention.multi_head_attention, bridge._graph_steps) = saved


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
    # training's three widths (encoder and decoder norms at 256^2, 128^2, 64^2);
    # then phase 9's new shapes: the f16 UNet's level-2 out_norm with FiLM at 4^2
    # (C=1024), the cross-attention UNet's SpatialTransformer norm (eps 1e-6,
    # C=1024 at 16^2) and eps 1e-6 at [8,512,32,32]
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
            ((BATCH, 512, 64, 64), False, 1e-6, torch.float32, True),
            ((BATCH, 1024, 4, 4), True, 1e-5, torch.bfloat16, True),
            ((BATCH, 1024, 16, 16), False, 1e-6, torch.bfloat16, True),
            ((BATCH, 512, 32, 32), False, 1e-6, torch.bfloat16, True)):
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
    # shapes and the same edge cases; then phase 9's f16 UNet up_2_us / up_1_us in_conv
    # at 4^2 and 8^2 (h below one tile of rows, w padded to 8), and untimed the other
    # up-convs of the f8 and f16 paths (UNet at 8^2 and 16^2, the decoders' levels)
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
            ((1, 20, 5, 7), 30, torch.float32, False),
            ((BATCH, 1024, 4, 4), 1024, torch.bfloat16, True),
            ((BATCH, 512, 8, 8), 512, torch.bfloat16, True),
            ((BATCH, 1024, 8, 8), 1024, torch.bfloat16, False),
            ((BATCH, 512, 16, 16), 512, torch.bfloat16, False),
            ((BATCH, 256, 64, 64), 256, torch.bfloat16, False),
            ((BATCH, 256, 32, 32), 256, torch.bfloat16, False),
            ((BATCH, 128, 128, 128), 128, torch.bfloat16, False)):
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
    # T and D below one 64 x 64 box; then the same in fp32 (VQGAN training); then
    # the f8 VQGAN's attention at 32^2 (T=1024) in both dtypes, and keys != queries:
    # 32^2 queries over a 64^2 context and over one token (a class embedding), in
    # both dtypes, and ragged Tk below one box; last, untimed, the SD v1 UNet's
    # attentions at 64^2 (D=40, compiled 64), 32^2 self and cross (D=80, compiled
    # 128, row split) and 16^2 cross (D=160, compiled 256, S past D skipped)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa(q, k, v, backend=None):
        if backend is None:
            return F.scaled_dot_product_attention(q, k, v, scale=q.shape[-1] ** -0.5)
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(q, k, v, scale=q.shape[-1] ** -0.5)

    for shape, tk, dtype, timed in (((BATCH, 1, 4096, 512), None, torch.bfloat16, True),
                                    ((1, 2, 1100, 128), None, torch.bfloat16, False),
                                    ((2, 1, 1024, 512), None, torch.bfloat16, False),
                                    ((1, 1, 50, 48), None, torch.bfloat16, False),
                                    ((BATCH, 1, 4096, 512), None, torch.float32, True),
                                    ((1, 2, 1100, 128), None, torch.float32, False),
                                    ((2, 1, 1024, 512), None, torch.float32, False),
                                    ((1, 1, 50, 48), None, torch.float32, False),
                                    ((BATCH, 1, 1024, 512), None, torch.bfloat16, True),
                                    ((BATCH, 1, 1024, 512), None, torch.float32, True),
                                    ((BATCH, 4, 1024, 128), 4096, torch.bfloat16, True),
                                    ((BATCH, 4, 1024, 128), 4096, torch.float32, True),
                                    ((BATCH, 4, 1024, 128), 1, torch.bfloat16, True),
                                    ((BATCH, 4, 1024, 128), 1, torch.float32, True),
                                    ((2, 3, 1100, 128), 77, torch.bfloat16, False),
                                    ((1, 2, 50, 48), 3, torch.float32, False),
                                    ((BATCH, 8, 4096, 40), None, torch.bfloat16, False),
                                    ((BATCH, 8, 1024, 80), None, torch.bfloat16, False),
                                    ((BATCH, 8, 1024, 80), 4096, torch.bfloat16, False),
                                    ((BATCH, 8, 256, 160), 4096, torch.bfloat16, False)):
        f32 = dtype == torch.float32
        B, H, T, D = shape
        Tk = T if tk is None else tk
        q = randn(*shape, dtype=dtype)
        k, v = (randn(B, H, Tk, D, dtype=dtype) for _ in range(2))
        # keys != queries: SDPA pinned to its memory-efficient backend (any Tk, fp32)
        backend = None if tk is None else SDPBackend.EFFICIENT_ATTENTION
        work = dict(flops=4 * B * H * T * Tk * D, peak=PEAK_TF32_FLOPS if f32 else PEAK_BF16_FLOPS,
                    passes=3 if f32 else 1,
                    bytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(),
                    library=lambda q=q, k=k, v=v, be=backend: sdpa(q, k, v, be),
                    library_call="F.scaled_dot_product_attention(q, k, v, scale=D**-0.5)"
                    + ("" if backend is None else ", EFFICIENT_ATTENTION"),
                    backends=lambda q=q, k=k, v=v: sdpa_backends(q, k, v))
        if f32:  # the one-pass control at the VQGAN's self-attention shapes
            work.update(fma_peak=PEAK_FP32_FLOPS)
            if tk is None:
                work["one_pass"] = lambda q=q, k=k, v=v: attention_one_tf32_pass(q, k, v)
        fa.append((f"{list(shape)}{'' if tk is None else f' Tk={tk}'}{' fp32' if f32 else ''}",
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


def k1_grad_excess(grads, ref, dx=True):
    """The largest |kernel - twin| / bar over K1's gradients (dx first where
    ``dx``, then the weight, bias and FiLM gradients asked for). The twin
    differentiates E[x^2] - mean^2 through autograd, the kernel the closed
    form, both in fp32 from the same inputs: 16-bit dx may round an ulp apart
    (2^-7; fp32 1e-4); the per-channel sums over N x hw terms agree to fp32
    rounding of their largest terms (1e-4 of the largest value; 16-bit FiLM
    gradients also 2^-7 and 1e-3)."""
    worst = 0.0
    for i, (a, r) in enumerate(zip(grads, ref)):
        a, r, wide = a.float(), r.float(), a.dtype == torch.float32
        tol = 1e-4 if wide else 2 ** -7
        if i == 0 and dx:
            rtol, atol = tol, tol
        else:
            rtol, atol = tol, 1e-4 * float(r.abs().max()) + (0 if wide else 1e-3)
        worst = max(worst, float(((a - r).abs() / (atol + rtol * r.abs())).max()))
    return worst


def autograd_cases(dev):
    """[(kernel name, block key, (label, inputs requiring grad, call through the
    dispatcher, the kernel alone, the twin, gradient check))] for the kernels
    with an autograd Function: K1 at the UNet's FiLM + SiLU shape (bf16 x and
    FiLM, fp32 affine; its backward kernel within :func:`k1_grad_excess`'s
    bars), K3 at the VQGAN attention's in bf16 and in fp32 (VQGAN training;
    bit for bit, None)."""
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
                lambda: attention.attention_plain(q, k, v), None)

    return [
        ("group_norm", "autograd",
         (f"[{BATCH},1024,32,32] FiLM+SiLU", [x, w, b, f], lambda: gn(group_norm.group_norm),
          lambda: gn(group_norm.group_norm_cuda), lambda: gn(group_norm.group_norm_plain),
          k1_grad_excess)),
        ("flash_attention", "autograd", fa(torch.bfloat16)),
        ("flash_attention", "autograd_fp32", fa(torch.float32)),
    ]


def autograd_phase(name, case):
    """The kernel's autograd Function against the kernel (forward, bit for
    bit) and the twin (gradients: within the case's bars, else bit for bit);
    the backward's CUDA-event time. Returns the entry's ``autograd`` block."""
    label, inputs, through, kernel, plain, excess = case
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
    backward_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, grad_out, retain_graph=True),
                          runs=5)
    block = {"shape": label, "function_equals_kernel": same_out, "backward_ms": backward_ms}
    if excess is None:
        same_grads = block["grads_equal_twin_autograd"] = all(
            torch.equal(a, r) for a, r in zip(grads, ref))
        log(f"  {name} autograd {label}: output == kernel {same_out}, gradients == twin's "
            f"{same_grads}; backward (the twin's recompute) {backward_ms:.4f} ms")
    else:
        worst = block["grads_excess_over_bars"] = excess(grads, ref)
        again = torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
        block["grads_repeat_bitwise"] = all(torch.equal(a, r) for a, r in zip(grads, again))
        same_grads = worst <= 1 and block["grads_repeat_bitwise"]
        log(f"  {name} autograd {label}: output == kernel {same_out}, gradients vs twin's "
            f"|d|/bar {worst:.3f}, repeat bit for bit {block['grads_repeat_bitwise']}; "
            f"backward (its kernel) {backward_ms:.4f} ms")
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
    runner = BBDMRunner(cfg, device=dev, seed=0)
    model = runner.model
    log(f"  model: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params")

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
    with plain_ops():
        y_plain = model.encode(x_cond)
        z_plain = model.p_sample_loop(y, noise=noise, clip_denoised=False)
        ref32 = build_model(cfg.model, device=dev, dtype=torch.float32)
        ref32.load_state_dict(model.state_dict())
        y_32 = ref32.encode(x_cond)
        z_32 = ref32.p_sample_loop(y, noise=noise, clip_denoised=False)
        del ref32
    img = model.decode(z_kernel)
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
        if dev.type == "cuda" and not dist[f"{what}_kernel_vs_plain"] > 0:
            raise AssertionError(f"{what}: kernel path equals the twins: no twin ran")

    # the main path, counted: sample_to_eval through the runner
    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    with tempfile.TemporaryDirectory(prefix="bbdm_smoke_") as out_dir:
        runner.sample_to_eval(batches, out_dir)
        launches = {name: getattr(mod, attr).launches for name, (mod, attr) in counters.items()}
        log(f"  sample_to_eval: {BATCHES} batches of {BATCH}, launches {launches}")
        check_tree(out_dir, [n for b in batches for n in b["x_name"]],
                   [n for b in batches for n in b["x_cond_name"]], SAMPLE_STEP, SAMPLE_NUM, size)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    return launches, dist


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
    from bbdm_tpu_torch.models.layers import init_parameters

    m = build_model(cfg.model, device=dev, generator=torch.Generator(dev).manual_seed(11))
    model = jax_tree_from_state_dict(m)
    ema = dict(model)
    g = torch.Generator(dev).manual_seed(12)
    for part in ("unet", "cond_stage"):  # the EMA's own draws; the frozen VQGAN is shared
        if part in model:
            init_parameters(getattr(m, part), g)
            ema[part] = jax_tree_from_state_dict(getattr(m, part))
    del m
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


def textured_u8(size, seed):
    """A smooth RGB image with some noise, uint8 [size, size, 3]."""
    import numpy as np

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.sin(6 * yy[..., None] + 4 * xx[..., None] + rs.uniform(0, 2 * np.pi, 3))
    return np.clip(img * 100 + 128 + rs.randint(0, 12, (size, size, 3)), 0, 255).astype(np.uint8)


def filtered_rows(arr, filters):
    """uint8 [H, W, C] -> PNG image data (a filter byte, then the row), row r
    filtered by filters[r % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    import numpy as np

    H, W, C = arr.shape
    img = arr.reshape(H, W * C).astype(np.int32)
    out = []
    for r in range(H):
        cur = img[r]
        up = img[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int32), cur[:-C]])
        ul = np.concatenate([np.zeros(C, np.int32), up[:-C]])
        f = filters[r % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def write_filtered_png(path, arr, filters):
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    H, W, C = arr.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(filtered_rows(arr, filters), 6))
                + chunk(b"IEND", b""))


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
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    here = os.path.dirname(os.path.abspath(__file__))
    if configs is None:
        configs = {name: load_config(os.path.join(here, "configs", f"Template-{name}.yaml"))
                   for name in ("LBBDM-f4", "BBDM")}
    out, paths, emas = {}, {}, {}
    for name, cfg in configs.items():
        size = cfg.data.dataset_config.image_size
        data = os.path.join(root, f"data-{name}")
        write_dataset(data, size, pairs, seed=len(paths))
        cfg.data.dataset_config.dataset_path = data
        cfg.model.BB.params.sample_step = step
        vq = None
        if cfg.model.model_type == "LBBDM":
            vq = cfg.model.VQGAN.params.ckpt_path = os.path.join(root, f"{name}-vqgan.ckpt")
        emas[name] = write_checkpoints(cfg, dev, os.path.join(root, f"{name}.ckpt"), vq)
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
    short = SHORT
    for label, name, sampler, num, to_eval, needed in runs:
        result = os.path.join(root, f"results-{label}")
        argv = ["-c", paths[name, sampler, num], "--resume_model",
                os.path.join(root, f"{name}.ckpt"), "-r", result, "-s", str(CLI_SEED),
                "--gpu_ids", gpu_ids] + (["--sample_to_eval"] if to_eval else [])
        for mod, attr in counters.values():
            getattr(mod, attr).launches = 0
        runner = main_torch.main(argv)
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
        entry = {"launches": launches[label]}
        if to_eval:
            entry["tree"] = tree
        log(f"  {label}: launches {launches[label]}")
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
    del ref, euler, runners["f4_euler_sample_to_eval"]

    # heun through the kernels against heun through the twins, same noise
    heun = runners["f4_heun_sample_to_eval"]
    model = heun.model
    batch = next(iter(loader))
    x_cond = torch.from_numpy(batch["x_cond"]).permute(0, 3, 1, 2).to(heun.device)
    y = model.encode(x_cond)
    g = torch.Generator(heun.device).manual_seed(2)
    noise = [torch.randn(y.shape, generator=g, device=heun.device)
             for _ in range(model.noised_steps())]
    z_kernel = model.p_sample_loop(y, noise=noise, clip_denoised=False)
    with plain_ops():
        z_plain = model.p_sample_loop(y, noise=noise, clip_denoised=False)
        ref32 = build_fp32_copy(heun.config.model, model, heun.device)
        z_32 = ref32.p_sample_loop(y, noise=noise, clip_denoised=False)
        del ref32
    d = lambda a, b: float((a.float() - b.float()).abs().max())
    out["heun_latent_kernel_vs_plain"] = d(z_kernel, z_plain)
    out["heun_latent_bf16_vs_fp32"] = d(z_plain, z_32)
    log(f"  heun (f4, {len(model.coeffs.steps)}-entry grid, two UNet evals per step): "
        f"latent kernel vs plain {out['heun_latent_kernel_vs_plain']:.4f}, plain bf16 vs fp32 "
        f"{out['heun_latent_bf16_vs_fp32']:.4f}")
    if not torch.isfinite(z_kernel).all():
        raise AssertionError("heun: non-finite latent")
    if out["heun_latent_kernel_vs_plain"] > 2 * out["heun_latent_bf16_vs_fp32"]:
        raise AssertionError("heun: kernel path farther from the twins than 2x bf16 error")
    if torch.device(heun.device).type == "cuda" and not out["heun_latent_kernel_vs_plain"] > 0:
        raise AssertionError("heun: kernel path equals the twins: no twin ran")
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


def counted_backward(calls):
    """Wrap GroupNormFunction.backward: one entry in ``calls`` per call."""
    def make(backward):
        def counted(ctx, grad_out):
            calls.append(1)
            return backward(ctx, grad_out)
        return staticmethod(counted)
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
    import main_torch
    from bbdm_tpu_torch.config import load_config, save_config
    from bbdm_tpu_torch.models.layers import GroupNorm32
    from bbdm_tpu_torch.ops import group_norm

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

    # the training run, counted: the kernels' launches, K1's backward calls and launches
    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    group_norm.group_norm_bwd_cuda.launches = 0
    backwards = []
    result = os.path.join(root, "results-train")
    argv = ["-c", path, "--train", "--max_epoch", str(TRAIN_EPOCHS), "-r", result,
            "-s", str(CLI_SEED), "--gpu_ids", gpu_ids]
    with patched(group_norm.GroupNormFunction, "backward", counted_backward(backwards)):
        runner = main_torch.main(argv)
    short = SHORT
    launches = {short[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
    out = {"launches": launches}
    model = runner.model
    n_norms = sum(isinstance(m, GroupNorm32) for m in model.unet.modules())
    out["k1_backwards"] = len(backwards)
    out["k1_backward_launches"] = group_norm.group_norm_bwd_cuda.launches
    ckpt = runner.config.result.ckpt_path
    out["checkpoints"] = {f: os.path.getsize(os.path.join(ckpt, f))
                          for f in sorted(os.listdir(ckpt))}
    log(f"  train: {micro} microbatches, steps {runner.global_step}, epoch "
        f"{runner.global_epoch}, stop {runner.stop_reason}; launches {launches}; K1 backwards "
        f"{len(backwards)} ({n_norms} UNet GroupNorms x {micro}; backward launches "
        f"{out['k1_backward_launches']}); checkpoints {out['checkpoints']}")
    if runner.global_step != micro or len(backwards) != n_norms * micro \
            or out["k1_backward_launches"] != len(backwards):
        raise AssertionError("train: wrong step count, or not every UNet GroupNorm went "
                             "through GroupNormFunction and one launch of K1's backward")
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

    # one microbatch through the kernels against the twins (bf16, fp32), same
    # weights, batch, t and noise
    batch = next(iter(runner._build_loaders()[0]))
    x, _ = runner._put_batch(batch)
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


def gan_step_grads(runner, x, loss_config, lpips=None):
    """One VQGAN step without an update: ({"xrec", "gen_loss", "d_weight",
    "disc_loss", "gen_grad", "disc_grad"}, the gradients flattened, and the
    gradients of both players' parameters, None where none reached one); the
    BatchNorm statistics the discriminator term moves are put back. ``lpips``:
    the perceptual term's network."""
    from bbdm_tpu_torch.training.gan import make_vqgan_losses

    vq, disc = runner.model.vqgan, runner.model.discriminator
    saved = {k: b.clone() for k, b in disc.named_buffers()}
    gen_loss, disc_loss = make_vqgan_losses(vq, disc, loss_config, lpips=lpips)
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
    import main_torch
    from bbdm_tpu_torch.config import load_config, save_config
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

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
    runner = main_torch.main(["-c", path, "--train", "--max_epoch", str(VQ_EPOCHS), "-r",
                              os.path.join(root, "results-vqgan"), "-s", str(CLI_SEED),
                              "--gpu_ids", gpu_ids])
    short = SHORT
    launches = {short[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
    ckpt = runner.config.result.ckpt_path
    out = {"launches": launches, "steps": runner.global_step,
           "checkpoints": {f: os.path.getsize(os.path.join(ckpt, f))
                           for f in sorted(os.listdir(ckpt))}}
    count = lambda m: sum(p.numel() for p in m.parameters())
    out["params"] = {"vqgan": count(runner.model.vqgan),
                     "discriminator": count(runner.model.discriminator)}
    log(f"  vqgan train: {steps} steps, steps {runner.global_step}, epoch "
        f"{runner.global_epoch}; parameters {out['params']}; launches {launches}; "
        f"checkpoints {out['checkpoints']}")
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

    x, _ = runner._put_batch(next(iter(runner._build_loaders()[0])))
    runner.model.train()

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
    out["lbbdm_first_stage"] = {"weights_equal": same, "latent": list(z.shape),
                                "image": list(img.shape),
                                "finite": bool(torch.isfinite(img).all())}
    log(f"  as an LBBDM first stage: {json.dumps(out['lbbdm_first_stage'])}")
    if not (same and out["lbbdm_first_stage"]["finite"]
            and tuple(img.shape) == tuple(x.shape)):
        raise AssertionError("the trained VQGAN does not load as an LBBDM first stage")
    del lb, runner, sampled
    return out


# ------------------------------------------------------ VQGAN, perceptual

LPIPS_SEED, INCEPTION_SEED = 21, 22
LPIPS_TERM_RTOL = 1e-4  # the LPIPS term on the card against the CPU, relative


def random_lpips_state_dict(net, seed):
    """``LPIPS(net)`` weights from ``seed``: He-normal conv kernels, biases in
    [0, 0.1), heads uniform in [0, C^-1/2) (lpips trains them non-negative)."""
    from bbdm_tpu_torch.evaluation.lpips import LPIPS

    g = torch.Generator().manual_seed(seed)
    sd = LPIPS(net).state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k.startswith("net.") and k.endswith(".weight"):
                torch.nn.init.kaiming_normal_(v, nonlinearity="relu", generator=g)
            elif k.startswith("net."):
                v.uniform_(0.0, 0.1, generator=g)
            elif k.startswith("lin"):
                v.uniform_(0.0, v.shape[1] ** -0.5, generator=g)
    return sd


def random_inception_state_dict(seed):
    """``FIDInceptionV3`` weights from ``seed``: He-normal conv kernels, BatchNorm
    at identity (as ``scripts/make_random_inception.py``: the pool3 features
    neither vanish nor overflow over ~90 convolutions)."""
    from bbdm_tpu_torch.evaluation.inception import FIDInceptionV3

    g = torch.Generator().manual_seed(seed)
    sd = FIDInceptionV3().state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k.endswith("conv.weight"):
                torch.nn.init.kaiming_normal_(v, nonlinearity="relu", generator=g)
    return sd


def vqgan_perceptual_phase(dev, counters, root, gpu_ids="0", config=None):
    """Phase 7's second run (see the module docstring): ``main_torch.main --train``
    for 2 steps with ``perceptual_weight`` 1.0 and seeded random LPIPS-VGG
    weights; ``config`` lets a CPU rehearsal pass a tiny model."""
    import main_torch
    from bbdm_tpu_torch.checkpoints.io import load_checkpoint
    from bbdm_tpu_torch.config import load_config, save_config
    from bbdm_tpu_torch.evaluation.lpips import load_lpips

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = config or load_config(os.path.join(here, "configs", "Template-VQGAN-f4.yaml"))
    size = cfg.data.dataset_config.image_size
    data = os.path.join(root, "data-vqgan-lpips")
    write_single_dataset(data, size, VQ_COUNTS, seed=8)
    cfg.data.dataset_config.dataset_path = data
    cfg.data.dataset_config.flip = False
    weights = os.path.join(root, "lpips_vgg.pth")
    torch.save(random_lpips_state_dict("vgg", LPIPS_SEED), weights)
    loss = cfg.model.loss
    loss.disc_start, loss.perceptual_weight, loss.lpips_weights = 0, 1.0, weights
    t = cfg.training
    t.save_interval = t.validation_interval = t.sample_interval = 1
    path = os.path.join(root, "vqgan-lpips.yaml")
    save_config(cfg, path)
    steps = VQ_COUNTS[0] // cfg.data.train.batch_size
    log("reduced: " + json.dumps({
        "n_epochs": {"template": 100, "run": 1}, "steps": steps,
        "train/val/test images": list(VQ_COUNTS), "flip": {"template": True, "run": False},
        "disc_start": {"template": 30000, "run": 0},
        "perceptual_weight": 1.0, "lpips_weights": "random LPIPS-VGG (seed), .pth",
        "sample_interval": 1, "save_interval": 1, "weights": "random (seed)"}))

    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    runner = main_torch.main(["-c", path, "--train", "--max_epoch", "1", "-r",
                              os.path.join(root, "results-vqgan-lpips"), "-s", str(CLI_SEED),
                              "--gpu_ids", gpu_ids])
    short = SHORT
    launches = {short[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
    out = {"launches": launches, "steps": runner.global_step}
    log(f"  vqgan perceptual train: {steps} steps (one sample, validation and save), steps "
        f"{runner.global_step}; launches {launches}")
    if runner.global_step != steps:
        raise AssertionError("vqgan perceptual train: wrong step count")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"vqgan perceptual train: kernels {missing} were not launched")
    saved = sorted(load_checkpoint(os.path.join(runner.config.result.ckpt_path,
                                                "last_model.ckpt"))["model"])
    if saved != ["disc_stats", "discriminator", "vqgan"]:
        raise AssertionError(f"vqgan perceptual checkpoint holds {saved}")

    x, _ = runner._put_batch(next(iter(runner._build_loaders()[0])))
    lp = load_lpips(weights, net="vgg", device=dev)

    # every gradient of one step with the term: present and finite
    runner.model.train()
    values, grads = gan_step_grads(runner, x, loss, lpips=lp)
    params = list(runner.model.vqgan.named_parameters()) + list(
        runner.model.discriminator.named_parameters())
    absent = [n for (n, _), gr in zip(params, grads) if gr is None]
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads if gr is not None)
    out.update(gen_loss=float(values["gen_loss"]), d_weight=float(values["d_weight"]),
               absent_grads=len(absent), finite=finite,
               lpips_grads=sum(p.grad is not None for p in lp.parameters()))
    log(f"  vqgan perceptual step: generator loss {out['gen_loss']:.5f}, d_weight "
        f"{out['d_weight']:.5f}, {len(params)} parameters, {len(absent)} without a gradient, "
        f"finite {finite}, LPIPS parameters with a gradient {out['lpips_grads']}")
    if absent or not finite or out["lpips_grads"]:
        raise AssertionError(f"vqgan perceptual step: gradients absent {absent[:3]}, "
                             f"finite {finite}, LPIPS gradients {out['lpips_grads']}")
    del grads, values

    # the LPIPS term at the step's shape on the card against the same module on the CPU
    runner.model.eval()
    with torch.no_grad():
        xrec, _ = runner.model.vqgan(x)
        d_card = lp(x, xrec).float().cpu()
        d_cpu = load_lpips(weights, net="vgg", device="cpu")(x.cpu(), xrec.cpu())
    out["lpips_term"] = {"shape": list(x.shape), "card": d_card.tolist(),
                         "max_rel": float((d_card - d_cpu).abs().max() / d_cpu.abs().max())}
    log(f"  LPIPS-VGG term at {list(x.shape)}, card vs CPU: {json.dumps(out['lpips_term'])}")
    if not (torch.isfinite(d_card).all() and out["lpips_term"]["max_rel"] <= LPIPS_TERM_RTOL):
        raise AssertionError(f"LPIPS term: card vs CPU beyond {LPIPS_TERM_RTOL} relative")
    del runner, lp
    return out


# ------------------------------------------------------------- evaluation

EVAL_FEATURE_RTOL, EVAL_DISTANCE_RTOL = 1e-4, 1e-5


def eval_phase(dev, root, tree, step=SAMPLE_STEP, draws=SAMPLE_NUM):
    """Phase 8 (see the module docstring): ``preprocess_and_evaluation_torch.py``
    over phase 5's f4 euler ``sample_to_eval`` tree, every mode on the card
    against ``--cpu``, then the features and distances card against CPU. On a
    CPU ``dev`` (a rehearsal) both sides run on the CPU."""
    import io

    import numpy as np

    import preprocess_and_evaluation_torch as pe
    from bbdm_tpu_torch.evaluation import fid, lpips

    here = os.path.dirname(os.path.abspath(__file__))
    card = dev.type == "cuda"
    work = os.path.join(root, "eval")
    os.makedirs(work, exist_ok=True)
    weights = {"inception": os.path.join(work, "inception_he.pth"),
               "alex": os.path.join(work, "lpips_alex.pth"),
               "vgg": os.path.join(work, "lpips_vgg.pth")}
    torch.save(random_inception_state_dict(INCEPTION_SEED), weights["inception"])
    for net in ("alex", "vgg"):
        torch.save(random_lpips_state_dict(net, LPIPS_SEED), weights[net])

    def run(argv, on_cpu):
        """(value, stdout) of one in-process CLI run."""
        random.seed(0)  # max_min_LPIPS draws with the module-level random
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            value = pe.main(argv + (["--cpu"] if on_cpu or not card else []))
        return value, text.getvalue()

    def files(d):
        out = {}
        for p, _, fs in os.walk(d):
            for f in fs:
                with open(os.path.join(p, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(p, f), d)] = fh.read()
        return out

    out = {"tree": tree, "modes": {}}
    # the reference protocol: numeric names for LPIPS and diversity, the first
    # draws flat (by dataset name) for FID and PSNR/SSIM
    prep = {"rename_samples": [("renamed", str(step)), ("gt_renamed", "ground_truth")],
            "copy_samples": [("flat", str(step))]}
    for mode, jobs in prep.items():
        for dst, src in jobs:
            for side in ("card", "cpu"):
                run(["-f", mode, "-r", tree, "-s", src, "-t", os.path.join(work, f"{dst}-{side}")],
                    side == "cpu")
            same = files(os.path.join(work, f"{dst}-card")) == files(
                os.path.join(work, f"{dst}-cpu"))
            count = len(files(os.path.join(work, f"{dst}-card")))
            out["modes"].setdefault(mode, {})[dst] = {"files": count, "equal": same}
            if not same or not count:
                raise AssertionError(f"{mode} {src}: card and --cpu wrote different files")
    renamed, gt_renamed = (os.path.join(work, f"{d}-card") for d in ("renamed", "gt_renamed"))
    flat, gt = os.path.join(work, "flat-card"), os.path.join(tree, "ground_truth")
    metric = {
        "LPIPS": ["-s", renamed, "-t", gt_renamed, "-n", str(draws), "--weights",
                  weights["alex"]],
        "max_min_LPIPS": ["-s", renamed, "-t", gt_renamed, "-n", str(draws), "--weights",
                          weights["alex"]],
        "diversity": ["-s", renamed, "-n", str(draws)],
        "FID": ["-s", flat, "-t", gt, "--weights", weights["inception"]],
        "psnr_ssim": ["-s", flat, "-t", gt]}
    for mode, args in metric.items():
        a, text_a = run(["-f", mode] + args, False)
        b, text_b = run(["-f", mode] + args, True)
        va, vb = (np.asarray(list(v.values()) if isinstance(v, dict) else v, np.float64)
                  for v in (a, b))
        rel = float(np.abs(va - vb).max() / max(np.abs(vb).max(), 1e-30))
        out["modes"][mode] = {"card": a, "cpu": b, "max_rel": rel}
        log(f"  {mode}: card {a}, --cpu {b}, max relative difference {rel:.3e}")
        if not np.isfinite(va).all():
            raise AssertionError(f"{mode}: not finite on the card")
        if mode in ("LPIPS", "max_min_LPIPS") and rel > EVAL_DISTANCE_RTOL:
            raise AssertionError(f"{mode}: card vs --cpu beyond {EVAL_DISTANCE_RTOL}")
        if mode in ("diversity", "psnr_ssim") and text_a != text_b:
            raise AssertionError(f"{mode}: card and --cpu print differently")

    # the script itself, in its own process (on the card unless rehearsing)
    proc = subprocess.run([sys.executable, os.path.join(here, "preprocess_and_evaluation_torch.py"),
                           "-f", "LPIPS"] + metric["LPIPS"] + ([] if card else ["--cpu"]),
                          capture_output=True, text=True, timeout=300, cwd=here)
    printed = [float(line.split(":")[1]) for line in proc.stdout.splitlines()
               if line.startswith("lpips_distance:")]
    out["script_lpips"] = printed
    log(f"  preprocess_and_evaluation_torch.py -f LPIPS in its own process: rc "
        f"{proc.returncode}, {printed}")
    if proc.returncode or len(printed) != 1 or abs(
            printed[0] - out["modes"]["LPIPS"]["card"]) > EVAL_DISTANCE_RTOL * abs(printed[0]):
        raise AssertionError(f"the script's LPIPS differs or failed: {proc.stderr[-2000:]}")

    # features and per-pair distances, card against CPU
    models = {d: fid.load_fid_model(weights["inception"], d) for d in (dev, "cpu")}
    feats = [fid.compute_features_for_path(flat, m) for m in models.values()]
    rel = np.linalg.norm(feats[0] - feats[1], axis=1) / np.linalg.norm(feats[1], axis=1)
    out["features"] = {"shape": list(feats[0].shape), "max_rel": float(rel.max())}
    pairs = [(os.path.join(gt, n), os.path.join(flat, n)) for n in sorted(os.listdir(flat))]
    for net in ("alex", "vgg"):
        d = [lpips.batched_distances(lpips.load_lpips(weights[net], net, dv), pairs)
             for dv in (dev, "cpu")]
        out[f"distances_{net}"] = {"pairs": len(pairs), "mean": float(d[0].mean()),
                                   "max_rel": float((np.abs(d[0] - d[1]) / np.abs(d[1])).max())}
    log("  card vs CPU: " + json.dumps({k: out[k] for k in ("features", "distances_alex",
                                                             "distances_vgg")}))
    if out["features"]["max_rel"] > EVAL_FEATURE_RTOL:
        raise AssertionError(f"Inception features: card vs CPU beyond {EVAL_FEATURE_RTOL}")
    for net in ("alex", "vgg"):
        if out[f"distances_{net}"]["max_rel"] > EVAL_DISTANCE_RTOL:
            raise AssertionError(f"LPIPS {net}: card vs CPU beyond {EVAL_DISTANCE_RTOL}")
    return out


# ------------------------------------------------ latent paths: f8, f16, xattn

PATH_PAIRS = (8, 8, 8)  # train (flipped in f8/f16: 16), val, test pairs at 256^2
PATH_STEP = 4  # sampling steps (20, then 10: cut to pay for phases 14 and 12 (e))


def path_configs():
    """{name: ConfigNode} of phase 9's paths: ``Template-LBBDM-f8.yaml`` and
    ``Template-LBBDM-f16.yaml`` as they stand, and ``Template-LBBDM-f4.yaml``
    with the cross-attention UNet (``use_spatial_transformer``, depth 1, a
    SpatialRescaler context of 3 channels concatenated and attended to)."""
    from bbdm_tpu_torch.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    load = lambda n: load_config(os.path.join(here, "configs", f"Template-{n}.yaml"))
    xattn = load("LBBDM-f4")
    xattn.model.model_name = "LBBDM-f4-xattn"
    u = xattn.model.BB.params.UNetParams
    u.use_spatial_transformer, u.transformer_depth, u.context_dim = True, 1, 3
    u.condition_key, u.in_channels = "SpatialRescaler", 6
    return {"LBBDM-f8": load("LBBDM-f8"), "LBBDM-f16": load("LBBDM-f16"),
            "LBBDM-f4-xattn": xattn}


def kernel_calls(model_config, batch):
    """The calls of an LBBDM (or a pixel BBDM, whose encoder and decoder parts
    are empty) that launch a kernel on a CUDA tensor, from its modules: the UNet
    in eval and in training mode, the VQGAN encoder and decoder
    walked on the meta device (no memory, no arithmetic) at ``batch`` with
    recorders in place of the three ops. {part: Counter of (kernel, shape)};
    K1 every GroupNorm (N, C, H, W); K2 every eval-mode up-conv (N, ci, h, w,
    co); K3 the attentions the dispatch sends to it, as ``attention.flash_route``
    decides (B, H, Tq, D, Tk)."""
    from collections import Counter

    from bbdm_tpu_torch.models.bridge import BrownianBridgeModel
    from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel
    from bbdm_tpu_torch.ops import attention, group_norm, upsample_conv

    seen = Counter()

    def k1(x, *a, **kw):
        seen["K1", tuple(x.shape)] += 1
        return torch.empty_like(x)

    def k2(x, w, b, *, dtype=None, combined=None):
        N, ci, h, wd = x.shape
        seen["K2", (N, ci, h, wd, w.shape[0])] += 1
        return x.new_empty((N, w.shape[0], 2 * h, 2 * wd),
                           dtype=dtype or torch.promote_types(x.dtype, w.dtype))

    def k3(q, k, v):
        if attention.flash_route(q.shape[-2], k.shape[-2], q.shape[-1], q.dtype):
            seen["K3", (*q.shape, k.shape[-2])] += 1
        return torch.empty_like(q)

    saved = group_norm.group_norm, upsample_conv.upsample2x_conv3x3, attention.multi_head_attention
    group_norm.group_norm, upsample_conv.upsample2x_conv3x3, attention.multi_head_attention = \
        k1, k2, k3
    out = {}
    try:
        meta = torch.device("meta")
        u = model_config.BB.params.UNetParams
        if model_config.model_type == "LBBDM":
            model = LatentBrownianBridgeModel(model_config, device=meta).eval()
            dd = model_config.VQGAN.params.ddconfig
            size = dd.resolution
            z = (batch, dd.z_channels, size // 2 ** (len(dd.ch_mult) - 1),
                 size // 2 ** (len(dd.ch_mult) - 1))
        else:  # pixel BBDM: no first stage, the UNet at the image size
            model = BrownianBridgeModel(model_config, device=meta).eval()
            z = (batch, u.out_channels, u.image_size, u.image_size)
        ctx = None
        if model.condition_key != "nocond":
            ctx = torch.empty(batch, u.in_channels - u.out_channels, z[2], z[3], device=meta)
        t = torch.zeros(batch, dtype=torch.int32, device=meta)
        parts = [("unet", lambda: model.unet.eval()(torch.empty(z, device=meta), t, ctx)),
                 ("unet_train", lambda: model.unet.train()(torch.empty(z, device=meta), t,
                                                            ctx))]
        if model_config.model_type == "LBBDM":
            parts += [("encoder", lambda: model.vqgan.encoder(
                          torch.empty(batch, 3, size, size, device=meta))),
                      ("decoder", lambda: model.vqgan.decoder(torch.empty(z, device=meta)))]
        out.update(encoder=Counter(), decoder=Counter())
        with torch.no_grad():
            for part, run in parts:
                seen.clear()
                run()
                out[part] = Counter(seen)
    finally:
        group_norm.group_norm, upsample_conv.upsample2x_conv3x3, attention.multi_head_attention = \
            saved
    return out


def expected_launches(calls, *, steps=0, draws=0, batches=0, microbatches=0):
    """Launches per kernel of ``batches`` sample_to_eval batches (one encode,
    then per draw ``steps`` UNet forwards and a decode) or of ``microbatches``
    training-mode loss evaluations (two encodes and a UNet forward each)."""
    n = lambda part, k: sum(c for (kk, _), c in calls[part].items() if kk == k)
    return {k: batches * (n("encoder", k) + draws * (steps * n("unet", k) + n("decoder", k)))
            + microbatches * (2 * n("encoder", k) + n("unet_train", k))
            for k in ("K1", "K2", "K3")}


def latent_paths_phase(dev, counters, root, gpu_ids="0", configs=None, step=PATH_STEP,
                       pairs=PATH_PAIRS):
    """Phase 9 (see the module docstring): each of :func:`path_configs` through
    ``main_torch.main`` at full width; ``configs`` lets a CPU rehearsal pass
    tiny models. Returns {path: results}."""
    import shutil

    out = {}
    for name, cfg in (configs or path_configs()).items():
        t0 = time.time()
        work = os.path.join(root, name)
        try:
            out[name] = latent_path(dev, counters, work, name, cfg, gpu_ids, step, pairs)
        finally:
            shutil.rmtree(work, ignore_errors=True)  # a few GB of checkpoints each
        log(f"  {name}: ok ({time.time() - t0:.1f} s)")
        torch.cuda.empty_cache()
    return out


def latent_path(dev, counters, work, name, cfg, gpu_ids, step, pairs):
    import main_torch
    from bbdm_tpu_torch.config import save_config
    from bbdm_tpu_torch.data import DataLoader, get_dataset
    from bbdm_tpu_torch.ops import group_norm

    size = cfg.data.dataset_config.image_size
    n_train, n_val, n_test = pairs
    data = os.path.join(work, "data")
    write_dataset(data, size, n_test, seed=9, train=n_train, val=n_val)
    cfg.data.dataset_config.dataset_path = data
    cfg.model.BB.params.sample_step = step
    cfg.testing.sample_num = 1
    cfg.model.VQGAN.params.ckpt_path = os.path.join(work, "vqgan.ckpt")
    write_checkpoints(cfg, dev, os.path.join(work, "model.ckpt"), cfg.model.VQGAN.params.ckpt_path)
    t = cfg.training
    t.sample_interval, t.save_interval, t.validation_interval = 1000, 1, 1
    path = os.path.join(work, "config.yaml")
    save_config(cfg, path)
    bs = cfg.data.test.batch_size
    flip = 2 if cfg.data.dataset_config.flip else 1
    micro = n_train * flip // cfg.data.train.batch_size
    calls = kernel_calls(cfg.model, bs)
    shapes = {part: sorted(f"{k} {list(s)} x{c}" for (k, s), c in cnt.items())
              for part, cnt in calls.items()}
    log(f"  {name}: kernel calls by part (the modules walked on meta): " + json.dumps(shapes))
    log("reduced: " + json.dumps({
        "path": name, "sample_step": {"template": 200, "run": step},
        "sample_num": {"template": 5, "run": 1},
        "n_epochs": {"template": 100, "run": 1}, "microbatches": micro,
        "train/val/test pairs": list(pairs), "sample_interval": "none during training",
        "weights": "random (seeds 11, 12), VQGAN written by the smoke"}))
    out = {}

    def counted(argv):
        for mod, attr in counters.values():
            getattr(mod, attr).launches = 0
        group_norm.group_norm_bwd_cuda.launches = 0
        runner = main_torch.main(argv)
        return runner, {SHORT[k]: getattr(mod, attr).launches
                        for k, (mod, attr) in counters.items()}

    def check(what, got, want):
        log(f"  {name} {what}: launches {got}, derived from the code {want}")
        if got != want:
            raise AssertionError(f"{name} {what}: launches {got} != {want}")

    # --sample_to_eval: one batch, one draw
    runner, launches = counted(
        ["-c", path, "--sample_to_eval", "--resume_model", os.path.join(work, "model.ckpt"),
         "-r", os.path.join(work, "results"), "-s", str(CLI_SEED), "--gpu_ids", gpu_ids])
    batches = n_test // bs
    check("sample_to_eval", launches, expected_launches(
        calls, steps=len(runner.model.coeffs.steps), draws=1, batches=batches))
    names = [f"{i:04d}" for i in range(n_test)]
    check_tree(runner.config.result.sample_to_eval_path, names, names, step, 1, size)
    out["sample_to_eval"] = {"launches": launches}
    # the latent through the kernels against the twins (same weights and noise)
    batch = next(iter(DataLoader(get_dataset(runner.config.data)[2], bs)))
    model = runner.model
    x_cond = torch.from_numpy(batch["x_cond"]).permute(0, 3, 1, 2).to(runner.device)
    y = model.encode(x_cond, latent_stats=runner.latent_stats)
    ctx = model.get_cond_stage_context(x_cond)
    g = torch.Generator(runner.device).manual_seed(3)
    noise = [torch.randn(y.shape, generator=g, device=runner.device)
             for _ in range(model.noised_steps())]
    z_k = model.p_sample_loop(y, ctx, noise=noise, clip_denoised=False)
    with plain_ops():
        y_p = model.encode(x_cond, latent_stats=runner.latent_stats)
        z_p = model.p_sample_loop(y, ctx, noise=noise, clip_denoised=False)
        ref32 = build_fp32_copy(cfg.model, model, runner.device)
        y_32 = ref32.encode(x_cond, latent_stats=runner.latent_stats)
        z_32 = ref32.p_sample_loop(y, ctx.float() if ctx is not None else None, noise=noise,
                                   clip_denoised=False)
        del ref32
    d = lambda a, b: float((a.float() - b.float()).abs().max())
    agree = {"encode_kernel_vs_plain": d(y, y_p), "encode_bf16_vs_fp32": d(y_p, y_32),
             "latent_kernel_vs_plain": d(z_k, z_p), "latent_bf16_vs_fp32": d(z_p, z_32)}
    out["agreement"] = agree
    log(f"  {name} sample_to_eval (batch {bs}, 1 draw, {step} steps): kernels vs twins "
        f"{json.dumps(agree)}")
    if not torch.isfinite(z_k).all():
        raise AssertionError(f"{name}: non-finite latent")
    for what in ("encode", "latent"):
        if agree[f"{what}_kernel_vs_plain"] > 2 * agree[f"{what}_bf16_vs_fp32"]:
            raise AssertionError(f"{name} {what}: kernel path farther from the twins than 2x "
                                 "bf16 error")
        if torch.device(runner.device).type == "cuda" and not agree[f"{what}_kernel_vs_plain"] > 0:
            raise AssertionError(f"{name} {what}: kernel path equals the twins: no twin ran")
    del runner, model

    # --train: one epoch, one validation epoch, one save
    runner, launches = counted(
        ["-c", path, "--train", "--max_epoch", "1", "-r", os.path.join(work, "results-train"),
         "-s", str(CLI_SEED), "--gpu_ids", gpu_ids])
    check("train", launches, expected_launches(
        calls, microbatches=micro + n_val // cfg.data.val.batch_size))
    # one backward launch per K1 forward under grad: the UNet's, each microbatch
    backward = group_norm.group_norm_bwd_cuda.launches
    check("train K1 backward", backward, micro * sum(
        c for (k, _), c in calls["unet_train"].items() if k == "K1"))
    if runner.global_step != micro:
        raise AssertionError(f"{name} train: {runner.global_step} steps, not {micro}")
    ckpt = runner.config.result.ckpt_path
    files = {f: os.path.getsize(os.path.join(ckpt, f)) for f in sorted(os.listdir(ckpt))}
    if {"last_model.ckpt", "last_optim_sche.ckpt"} - set(files):
        raise AssertionError(f"{name} train: checkpoint files {sorted(files)}")
    tr = out["train"] = {"launches": launches, "microbatches": micro,
                         "k1_backward_launches": backward, "checkpoints": files}
    # every trainable parameter's gradient, present and finite
    model = runner.model
    tb = next(iter(runner._build_loaders()[0]))
    x, _ = runner._put_batch(tb)
    g = torch.Generator(runner.device).manual_seed(6)
    zshape = model.encode(x).shape
    tt = torch.randint(0, model.num_timesteps, (x.shape[0],), generator=g, device=x.device)
    nz = torch.randn(zshape, generator=g, device=x.device)
    loss, grads = microbatch_grads(model, runner, tb, tt, nz)
    names_ = list(model.trainable_parameters())
    absent = [n for n, gr in zip(names_, grads) if gr is None]
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads if gr is not None)
    model.eval()
    tr.update(loss=float(loss), trainable_grads=len(grads), absent_grads=len(absent),
              finite_grads=finite)
    log(f"  {name} train ({micro} microbatches, one validation epoch, one save): gradients "
        f"{len(grads) - len(absent)} of {len(grads)} trainable, finite {finite}; "
        f"checkpoints {files}")
    if absent or not finite:
        raise AssertionError(f"{name} train: gradients absent {absent[:3]}, finite {finite}")
    return out


# ----------------------------------------------------------- data parallel

DP_RANKS, DP_EPOCHS, DP_VQ_STEPS = 2, 2, 2
DP_PAIRS = (32, 8, 8)  # train, val, test pairs at 256^2 (VQGAN: 16, 8, 8 images)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kernel_launches(reset=False):
    """{K1, K2, K3: launches} of this process's kernel wrappers, after setting
    them to 0 when ``reset`` (the benches' count, imported when called)."""
    from bbdm_tpu_torch.tools.bench import kernel_launches as launches

    return launches(reset)


def dp_rank(rank, ranks, port, dev, job, args, setup=None):
    """Rank ``rank`` of ``ranks`` spawned on ``dev`` (all on card 0) over gloo:
    ``job(rank, ranks, dev, *args)``. ``setup`` (a CPU rehearsal's stubs) runs first."""
    if setup is not None:
        setup()
    import bbdm_tpu_torch  # noqa: F401  (sets TF32 off)
    from bbdm_tpu_torch import parallel

    parallel.initialize(rank, ranks, init_method=f"tcp://127.0.0.1:{port}", local_size=ranks,
                        backend="gloo", device=dev)
    try:
        job(rank, ranks, dev, *args)
    finally:
        parallel.shutdown()


def spawn_ranks(dev, job, args, setup=None):
    """``job`` as ``DP_RANKS`` ranks, each its own process sharing ``dev`` over gloo."""
    import torch.multiprocessing as mp

    mp.start_processes(dp_rank, args=(DP_RANKS, free_port(), dev, job, args, setup),
                       nprocs=DP_RANKS, join=True, start_method="spawn")


def dp_runner(cls, path, dev, result, mode, fp32=False):
    """``cls`` built from the config at ``path`` as ``main_torch`` builds it for
    ``mode`` (--train or --sample_to_eval) on ``dev``; ``fp32``: the
    configuration in fp32."""
    import main_torch
    from bbdm_tpu_torch.config import apply_cli_overrides, load_config

    args = main_torch.parse_args(["-c", path, mode, "-r", result, "-s", str(CLI_SEED)])
    cfg = apply_cli_overrides(load_config(path), args)
    if fp32:
        cfg.model.mixed_precision = False
    return cls(cfg, device=dev)


def dp_dump(out, name, rank, ranks, record):
    if rank == 0:
        torch.save(record, os.path.join(out, f"{name}_of{ranks}.pt"))
    with open(os.path.join(out, f"{name}_rank{rank}_of{ranks}.json"), "w") as f:
        json.dump({k: v for k, v in record.items()
                   if k == "launches" or isinstance(v, (int, float, str, list))}, f)


def dp_train_job(rank, ranks, dev, path, out, fp32=False):
    """Phase 10 (a) on one rank: ``DP_EPOCHS`` epochs of the LBBDM-f4 train step
    over this rank's rows of each node batch (``accumulate_grad_batches`` 4):
    the losses and lr, the kernels' launches, and on rank 0 the trainable
    parameters before and after. ``fp32``: the fp32 model through the plain
    twins."""
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    tag = "train-fp32" if fp32 else "train"
    runner = dp_runner(BBDMRunner, path, dev, os.path.join(out, f"{tag}-{ranks}"), "--train",
                       fp32)
    loader = runner._build_loaders()[0]
    step = runner.build_train_step()
    flat = lambda: torch.cat([p.detach().float().flatten() for p in runner.state.params.values()])
    before = flat().cpu()
    losses, lrs = [], []
    runner.model.train()
    kernel_launches(reset=True)
    with plain_ops() if fp32 else contextlib.nullcontext():
        for epoch in range(DP_EPOCHS):
            loader.set_epoch(epoch)
            for batch in loader:
                x, y = runner._put_batch(batch)
                m = step(runner.state, x, y, runner.train_generator)
                losses.append(float(m["loss"]))
                lrs.append(float(m["lr"]))
    dp_dump(out, tag, rank, ranks, {
        "launches": kernel_launches(), "losses": losses, "lrs": lrs,
        "microbatches": runner.state.step, "rows": int(x.shape[0]), "before": before,
        "after": flat().cpu()})


def dp_sample_job(rank, ranks, dev, path, out, fp32=False):
    """Phase 10 (b) on one rank: ``BBDMRunner.test`` with --sample_to_eval."""
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    tag = "sample-fp32" if fp32 else "sample"
    runner = dp_runner(BBDMRunner, path, dev, os.path.join(out, f"{tag}-{ranks}"),
                       "--sample_to_eval", fp32)
    kernel_launches(reset=True)
    with plain_ops() if fp32 else contextlib.nullcontext():
        runner.test()
    torch.cuda.synchronize()
    dp_dump(out, tag, rank, ranks, {"launches": kernel_launches(),
                                    "tree": runner.config.result.sample_to_eval_path})


def dp_vqgan_job(rank, ranks, dev, path, out, tag="vqgan", steps=DP_VQ_STEPS):
    """Phase 10 (c) on one rank (and phase 11 (c) under ``tag``): ``steps``
    VQGAN-f4 steps (fp32) over this rank's rows, with the first step's
    gradients as the optimizers get them (averaged over ranks; where the state
    is sharded, its reduced shards gathered whole); the codes the one-rank run
    picks are recorded there and pinned here (a near tie broken the other way
    moves a step far beyond rounding: phase 7), counting the codes this rank
    would pick otherwise."""
    from bbdm_tpu_torch.parallel import collectives
    from bbdm_tpu_torch.parallel.collectives import local_rows
    from bbdm_tpu_torch.parallel.mesh import grid
    from bbdm_tpu_torch.runners.vqgan import VQGANRunner

    runner = dp_runner(VQGANRunner, path, dev, os.path.join(out, f"{tag}-{ranks}"), "--train")
    loader = runner._build_loaders()[0]
    step = runner.build_train_step()
    quantize = runner.model.vqgan.quantize
    codes_path = os.path.join(out, f"{tag}_codes.pt")
    pinned = torch.load(codes_path) if ranks > 1 else None
    codes, flips = [], [0]
    g = grid()

    def pin(nearest):
        def chosen(z):
            mine = nearest(z)
            if pinned is None:
                codes.append(mine.cpu())
                return mine
            theirs = pinned[len(codes)]
            theirs = theirs[local_rows(theirs.shape[0], g.data_index, g.data_size)] \
                .to(mine.device)
            codes.append(theirs)
            flips[0] += int((mine != theirs).sum())
            return theirs
        return chosen

    flat = lambda ts: torch.cat([t.detach().flatten() for t in ts]).cpu()
    model = runner.model
    n_gen = len(list(model.vqgan.parameters()))
    with runner.full_weights():
        before = {"vqgan": flat(model.vqgan.parameters()),
                  "discriminator": flat(model.discriminator.parameters())}
    grads = {}

    def first_grads(reduce):
        def wrapped(tensors):
            reduce(tensors)
            if not grads and len(tensors) > 2:  # both players' (not d_weight's pair)
                grads.update(vqgan=flat(tensors[:n_gen]), discriminator=flat(tensors[n_gen:]))
        return wrapped

    sharding = runner.state.sharding

    def first_shards(reduce):
        """The sharded step's reduced gradients, the first step's gathered whole."""
        def wrapped(params, tensors):
            out = reduce(params, tensors)
            if not grads:
                whole = sharding.whole(params, out)
                grads.update(vqgan=flat(whole[:n_gen]), discriminator=flat(whole[n_gen:]))
            return out
        return wrapped

    model.train()
    metrics = []
    kernel_launches(reset=True)
    with patched(quantize, "nearest", pin), \
            (patched(collectives, "all_reduce_mean_", first_grads) if sharding is None
             else patched(sharding, "reduce", first_shards)):
        for _, batch in zip(range(steps), loader):
            x, _ = runner._put_batch(batch)
            m = step(runner.state, x, x, runner.train_generator)
            metrics.append({k: float(v) for k, v in m.items()})
    if pinned is None:
        torch.save(codes, codes_path)
    launches = kernel_launches()
    with runner.full_weights():
        dp_dump(out, tag, rank, ranks, {
            "launches": launches, "metrics": metrics, "code_flips": flips[0],
            "before": before, "grads": grads, "rows": int(x.shape[0]),
            "after": {"vqgan": flat(model.vqgan.parameters()),
                      "discriminator": flat(model.discriminator.parameters())},
            "stats": {k: b.detach().cpu() for k, b in model.discriminator.named_buffers()}})


def trace_kernels(path):
    """{device kernel name: launches} of a chrome trace."""
    from collections import Counter

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return Counter(e["name"] for e in events if e.get("cat") == "kernel")


def ckpt_keys(tree, prefix=""):
    """The key paths of a checkpoint tree."""
    if isinstance(tree, dict):
        return sorted(k for name, sub in tree.items() for k in ckpt_keys(sub, f"{prefix}/{name}"))
    return [prefix]


def parallel_phase(dev, root, configs=None, setup=None, pairs=DP_PAIRS):
    """Phase 10 (see the module docstring): (a)-(e). ``configs`` ({"lbbdm",
    "vqgan"} ConfigNodes) and ``setup`` let a CPU rehearsal pass tiny models
    and its stubs to the spawned ranks. Returns the phase's numbers."""
    import shutil

    import numpy as np

    import main_torch
    from bbdm_tpu_torch.checkpoints.io import load_checkpoint
    from bbdm_tpu_torch.config import load_config, save_config

    here = os.path.dirname(os.path.abspath(__file__))
    load = lambda n: load_config(os.path.join(here, "configs", f"Template-{n}.yaml"))
    cfg = configs["lbbdm"] if configs else load("LBBDM-f4")
    size = cfg.data.dataset_config.image_size
    work = os.path.join(root, "parallel")
    data = os.path.join(work, "data")
    n_train, n_val, n_test = pairs
    write_dataset(data, size, n_test, seed=13, train=n_train, val=n_val)
    cfg.data.dataset_config.dataset_path = data
    cfg.model.VQGAN.params.ckpt_path = None  # seeded random, the same on every rank
    cfg.model.BB.params.sample_step = SAMPLE_STEP
    cfg.testing.sample_num = 1
    path = os.path.join(work, "lbbdm.yaml")
    save_config(cfg, path)
    bs, acc = cfg.data.train.batch_size, int(cfg.training.accumulate_grad_batches)
    micro = DP_EPOCHS * n_train // bs
    calls = kernel_calls(cfg.model, bs // DP_RANKS)
    log("reduced: " + json.dumps({
        "phase": "10 (a, b)", "microbatches": micro, "updates": micro // acc,
        "train/val/test pairs": list(pairs), "sample_step": {"template": 200, "run": SAMPLE_STEP},
        "sample_num": {"template": 5, "run": 1},
        "weights": "random (seed), VQGAN too", "ranks": f"1 and {DP_RANKS} on card 0 (gloo)"}))
    out = {}

    def read(name, ranks):
        per_rank = []
        for r in range(ranks):
            with open(os.path.join(work, f"{name}_rank{r}_of{ranks}.json")) as f:
                per_rank.append(json.load(f))
        return torch.load(os.path.join(work, f"{name}_of{ranks}.pt")), per_rank

    def check_launches(what, per_rank, want):
        got = [r["launches"] for r in per_rank]
        log(f"  {what}: launches per rank {got}, derived from the code {want}")
        if any(g != want for g in got):
            raise AssertionError(f"{what}: launches {got} != {want}")

    # the one-rank runs of (a)-(c) (1 rank, and 1 rank in fp32 through the
    # twins for (a) and (b)), then one spawn of 2 ranks running (a)-(c) in turn
    dp_train_job(0, 1, dev, path, work)
    dp_train_job(0, 1, dev, path, work, fp32=True)
    dp_sample_job(0, 1, dev, path, work)
    dp_sample_job(0, 1, dev, path, work, fp32=True)
    vcfg = configs["vqgan"] if configs else load("VQGAN-f4")
    vdata = os.path.join(work, "data-vqgan")
    vbs = vcfg.data.train.batch_size
    write_single_dataset(vdata, vcfg.data.dataset_config.image_size,
                         (DP_VQ_STEPS * vbs, vbs, vbs), seed=14)
    vcfg.data.dataset_config.dataset_path = vdata
    vcfg.data.dataset_config.flip = False
    vcfg.model.loss.disc_start, vcfg.model.loss.perceptual_weight = 0, 0.0
    vcfg.model.loss.lpips_weights = None
    vpath = os.path.join(work, "vqgan.yaml")
    save_config(vcfg, vpath)
    dp_vqgan_job(0, 1, dev, vpath, work)
    torch.cuda.empty_cache()
    spawn_ranks(dev, sh_jobs, ([(dp_train_job, (path, work)), (dp_sample_job, (path, work)),
                                (dp_vqgan_job, (vpath, work))],), setup)

    # (a) LBBDM-f4 training: 1 rank, 1 rank in fp32 through the twins, 2 ranks
    (one, one_r), (f32, _), (two, two_r) = (read(n, r) for n, r in (
        ("train", 1), ("train-fp32", 1), ("train", DP_RANKS)))
    want = expected_launches(calls, microbatches=micro)
    check_launches("(a) train, 1 rank", one_r, want)
    check_launches(f"(a) train, {DP_RANKS} ranks", two_r, want)
    lr = float(cfg.model.BB.optimizer.lr)
    d_two, d_f32 = two["after"] - one["after"], f32["after"] - one["after"]
    update = one["after"] - one["before"]
    a = {"rows_per_rank": {"1": one_r[0]["rows"], str(DP_RANKS): two_r[0]["rows"]},
         "loss": {"1": one["losses"], str(DP_RANKS): two["losses"], "fp32": f32["losses"]},
         "lr": {"1": one["lrs"], str(DP_RANKS): two["lrs"]},
         "param_max_abs": {f"{DP_RANKS}_vs_1": float(d_two.abs().max()),
                           "fp32_vs_1": float(d_f32.abs().max()),
                           "adam_bound": 2 * lr * (micro // acc)},
         "update_norm_rel": {f"{DP_RANKS}_vs_1": float(d_two.norm() / update.norm()),
                             "fp32_vs_1": float(d_f32.norm() / update.norm())},
         "loss_max_abs": {f"{DP_RANKS}_vs_1": max(abs(p - q) for p, q in
                                                  zip(two["losses"], one["losses"])),
                          "fp32_vs_1": max(abs(p - q) for p, q in
                                           zip(f32["losses"], one["losses"]))},
         "launches": two_r[0]["launches"]}
    out["train"] = a
    log(f"  (a) LBBDM-f4 train, {micro} microbatches ({micro // acc} updates) at node batch "
        f"{bs}, {DP_RANKS} ranks on one card against 1: " + json.dumps(
            {k: a[k] for k in ("param_max_abs", "update_norm_rel", "loss_max_abs", "lr")}))
    if two["lrs"] != one["lrs"] or [r["losses"] for r in two_r] != [two["losses"]] * DP_RANKS:
        raise AssertionError("(a): lr differs from 1 rank, or the ranks' losses differ")
    for k in ("param_max_abs", "update_norm_rel", "loss_max_abs"):
        if a[k][f"{DP_RANKS}_vs_1"] > 2 * a[k]["fp32_vs_1"]:
            raise AssertionError(f"(a): {k} of {DP_RANKS} ranks against 1 beyond twice bf16's "
                                 "distance from fp32")
    del one, two, f32, d_two, d_f32, update
    log("  (a): ok")

    # (b) --sample_to_eval of the test pairs: 1 rank, 1 rank fp32 twins, 2 ranks
    trees = {k: read_pngs(read(n, r)[0]["tree"]) for k, (n, r) in {
        "1": ("sample", 1), "fp32": ("sample-fp32", 1), "2": ("sample", DP_RANKS)}.items()}
    want = expected_launches(calls, steps=SAMPLE_STEP, draws=1,
                             batches=n_test // cfg.data.test.batch_size)
    for ranks in (1, DP_RANKS):
        check_launches(f"(b) sample_to_eval, {ranks} rank(s)", read("sample", ranks)[1], want)
    names = [f"{i:04d}" for i in range(n_test)]
    check_tree(read("sample", DP_RANKS)[0]["tree"], names, names, SAMPLE_STEP, 1, size)
    if sorted(trees["2"]) != sorted(trees["1"]):
        raise AssertionError("(b): the trees hold other files")
    diff = lambda k: np.stack([np.abs(trees[k][p].astype(int) - trees["1"][p])
                               for p in sorted(trees["1"]) if p.startswith(str(SAMPLE_STEP))])
    b = {"codes_max": {f"{DP_RANKS}_vs_1": int(diff("2").max()),
                       "fp32_vs_1": int(diff("fp32").max())},
         "codes_mean": {f"{DP_RANKS}_vs_1": float(diff("2").mean()),
                        "fp32_vs_1": float(diff("fp32").mean())},
         "share_differing": {f"{DP_RANKS}_vs_1": float((diff("2") > 0).mean()),
                             "fp32_vs_1": float((diff("fp32") > 0).mean())},
         "inputs_equal": all(np.array_equal(trees["2"][p], trees["1"][p]) for p in trees["1"]
                             if not p.startswith(str(SAMPLE_STEP))),
         "launches": read("sample", DP_RANKS)[1][0]["launches"]}
    out["sample_to_eval"] = b
    log(f"  (b) sample_to_eval, {n_test} pairs: samples of {DP_RANKS} ranks against 1 rank, "
        "in uint8 codes, beside bf16 against fp32 (1 rank): " + json.dumps(b))
    if not b["inputs_equal"] or b["codes_mean"][f"{DP_RANKS}_vs_1"] > \
            2 * b["codes_mean"]["fp32_vs_1"]:
        raise AssertionError(f"(b): {DP_RANKS} ranks differ from 1 by more than twice bf16's "
                             "mean distance from fp32, or the copied inputs differ")

    # (c) VQGAN-f4 training in fp32: 1 rank, 2 ranks, the codes pinned
    (one, one_r), (two, two_r) = read("vqgan", 1), read("vqgan", DP_RANKS)
    check_launches(f"(c) VQGAN train, {DP_RANKS} ranks (each as 1 rank)", two_r,
                   one_r[0]["launches"])
    bars = VQ_STEP_BARS["norm_rel"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    norm_rel = lambda a, b: float((a - b).norm() / b.norm())
    vlr = float(vcfg.model.optimizer.lr)
    players = ("vqgan", "discriminator")
    c = {"metrics_rel": {k: max(rel(p[k], q[k]) for p, q in zip(two["metrics"], one["metrics"]))
                         for k in ("loss", "d_loss", "d_weight")},
         "bn_stats_norm_rel": max(norm_rel(two["stats"][k], one["stats"][k])
                                  for k in one["stats"]),
         "grad_norm_rel": {n: norm_rel(two["grads"][n], one["grads"][n]) for n in players},
         # Adam's bar of tests/test_torch_train_step.py: within lr / 10 but for
         # one element in 10^4, every one within 2 lr per step
         "params_beyond_lr_10": {n: float(((two["after"][n] - one["after"][n]).abs()
                                           > vlr / 10).float().mean()) for n in players},
         "params_max_abs_over_lr": {n: float((two["after"][n] - one["after"][n]).abs().max())
                                    / vlr for n in players},
         "code_flips": [r["code_flips"] for r in two_r],
         "codes": DP_VQ_STEPS * vbs * (vcfg.data.dataset_config.image_size // 4) ** 2,
         "launches": two_r[0]["launches"]}
    c["bars"] = {"loss": bars["gen_loss"], "d_loss": bars["disc_grad"],
                 "d_weight": bars["gen_grad"], "bn_stats": bars["disc_grad"],
                 "vqgan": bars["gen_grad"], "discriminator": bars["disc_grad"],
                 "params_beyond_lr_10": 1e-4, "params_max_abs_over_lr": 2 * DP_VQ_STEPS}
    out["vqgan_train"] = c
    log(f"  (c) VQGAN-f4 train, {DP_VQ_STEPS} steps at node batch {vbs}, {DP_RANKS} ranks "
        "against 1 (relative), bars from VQ_STEP_BARS and Adam's: " + json.dumps(c))
    over = [k for k in ("loss", "d_loss", "d_weight") if c["metrics_rel"][k] > c["bars"][k]]
    over += ["bn_stats"] * (c["bn_stats_norm_rel"] > c["bars"]["bn_stats"])
    over += [f"{n} gradient" for n in players if c["grad_norm_rel"][n] > c["bars"][n]]
    over += [f"{n} {k}" for k in ("params_beyond_lr_10", "params_max_abs_over_lr")
             for n in players if c[k][n] > c["bars"][k]]
    if over:
        raise AssertionError(f"(c): {over} beyond their bars")

    # (d) NCCL: main_torch as one node of one rank (BBDM_MULTIHOST), train then
    # sample_to_eval, against the same run without a process group; (e) the
    # plain run's profiler window
    ccfg = load_config(path)
    ccfg.model.BB.params.UNetParams.num_res_blocks = 1
    ccfg.training.accumulate_grad_batches, ccfg.training.n_epochs = 1, 1
    ccfg.training.sample_interval = 1000
    cpath, ppath = os.path.join(work, "cut.yaml"), os.path.join(work, "cut-profile.yaml")
    save_config(ccfg, cpath)
    ccfg.training.profile_dir = os.path.join(work, "profile")
    ccfg.training.profile_start_step, ccfg.training.profile_steps = 1, 1
    save_config(ccfg, ppath)
    gpu = "-1" if dev.type == "cpu" else "0"
    runs = {}
    env = {"BBDM_MULTIHOST": "1", "BBDM_NUM_PROCESSES": "1", "BBDM_PROCESS_ID": "0",
           "BBDM_COORDINATOR": f"127.0.0.1:{free_port()}"}
    for name, cfg_path, multi in (("plain", ppath, False), ("nccl", cpath, True)):
        saved = {k: os.environ.get(k) for k in env}
        if multi:
            os.environ.update(env)
        try:
            kernel_launches(reset=True)
            runner = main_torch.main(["-c", cfg_path, "--train", "-r",
                                      os.path.join(work, f"cut-{name}"), "-s", str(CLI_SEED),
                                      "--gpu_ids", gpu])
            train_launches = kernel_launches()
            backend = runner.world.backend
            ckpt = runner.config.result.ckpt_path
            del runner
            if multi:
                kernel_launches(reset=True)
                sampled = main_torch.main([
                    "-c", cfg_path, "--sample_to_eval", "--resume_model",
                    os.path.join(ckpt, "last_model.ckpt"), "-r", os.path.join(work, "cut-s2e"),
                    "-s", str(CLI_SEED), "--gpu_ids", gpu])
                runs["nccl_sample_launches"] = kernel_launches()
                check_tree(sampled.config.result.sample_to_eval_path, names, names,
                           SAMPLE_STEP, 1, size)
                del sampled
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        states = load_checkpoint(os.path.join(ckpt, "last_model.ckpt"))
        runs[name] = {"backend": backend, "launches": train_launches,
                      "files": sorted(os.listdir(ckpt)), "keys": ckpt_keys(states)}
        del states
        torch.cuda.empty_cache()
    d = {"backend": runs["nccl"]["backend"], "train_launches": runs["nccl"]["launches"],
         "sample_launches": runs["nccl_sample_launches"], "files": runs["nccl"]["files"],
         "keys": len(runs["nccl"]["keys"])}
    out["nccl"] = d
    log(f"  (d) main_torch as one node of one rank over {d['backend']}: " + json.dumps(d))
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    if d["backend"] != want_backend or runs["plain"]["backend"] is not None:
        raise AssertionError(f"(d): backends {d['backend']}, {runs['plain']['backend']}")
    if (runs["nccl"]["files"], runs["nccl"]["keys"]) != (runs["plain"]["files"],
                                                         runs["plain"]["keys"]):
        raise AssertionError("(d): the checkpoints of the two runs differ in files or keys")
    for what, launches, ks in (("train", d["train_launches"], ("K1", "K3")),
                               ("sample_to_eval", d["sample_launches"], ("K1", "K2", "K3"))):
        if any(launches[k] <= 0 for k in ks):
            raise AssertionError(f"(d) {what}: kernels {ks} not all launched: {launches}")

    traces = sorted(os.listdir(ccfg.training.profile_dir))
    if traces != ["steps_2-2.pt.trace.json"]:
        raise AssertionError(f"(e): profile_dir holds {traces}")
    every = trace_kernels(os.path.join(ccfg.training.profile_dir, traces[0]))
    ours = {k: sum(c for n, c in every.items() if frag in n)
            for k, frag in (("K1", "group_norm_kernel"), ("K3", "flash_attention_kernel"))}
    out["profile"] = {"trace": traces[0], "kernel_launches": ours}
    log(f"  (e) the profiler window's trace {traces[0]}, one microbatch: K1 and K3 launches "
        f"{json.dumps(ours)}")
    if dev.type == "cuda" and not all(ours.values()):
        raise AssertionError(f"(e): the trace does not name K1 and K3: {ours}")
    shutil.rmtree(work, ignore_errors=True)
    return out


# ------------------------------------------------------- FSDP and tensor parallel

SH_MICRO, SH_ACC, SH_TP_MICRO, SH_TP_VQ_BATCH = 4, 2, 2, 2


def state_bytes(runner) -> int:
    """The bytes of the train state this rank keeps between steps: parameters
    (the frozen VQGAN's too) and BatchNorm statistics, the optimizers'
    moments, the EMA and the gradient accumulator (``.grad`` unsharded)."""
    s = runner.state
    if s.sharding is not None:
        return s.sharding.persistent_bytes()
    params = sum(p.nbytes for p in runner.model.parameters())
    moments = sum(t.nbytes for v in s.optimizer.state.values() if isinstance(v, list) for t in v)
    ema = sum(t.nbytes for t in s.ema.values()) if s.ema else 0
    grads = sum(p.grad.nbytes for p in s.optimizer.params if p.grad is not None)
    return params + moments + ema + grads


def sh_train_job(rank, ranks, dev, path, out, tag, micro=SH_MICRO, fp32=False):
    """Phase 11 (a), (b) on one rank: ``micro`` microbatches of the LBBDM-f4
    train step (``SH_ACC`` per update) on this rank's shards and rows; the
    kernels' launches, the state's bytes and ``memory_allocated`` after the
    first microbatch (an update accumulating), the peak over the updates, the
    trainable parameters gathered after each update (outside the peak); under FSDP
    then ``last_model.ckpt`` and ``last_optim_sche.ckpt`` as ``train()`` writes
    them (every rank gathers, rank 0 writes; (d) samples from them). ``fp32``:
    the fp32 model through the plain twins."""
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    name = f"{tag}-fp32" if fp32 else tag
    runner = dp_runner(BBDMRunner, path, dev, os.path.join(out, f"{name}-{ranks}"), "--train",
                       fp32)
    loader = runner._build_loaders()[0]
    step = runner.build_train_step()
    flat = lambda: torch.cat([p.detach().float().flatten()
                              for p in runner.state.params.values()]).cpu()
    losses, lrs, kept, after, peak = [], [], {}, [], 0
    runner.model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_launches(reset=True)
    with plain_ops() if fp32 else contextlib.nullcontext():
        for _, batch in zip(range(micro), loader):
            x, y = runner._put_batch(batch)
            m = step(runner.state, x, y, runner.train_generator)
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
            if not kept:
                torch.cuda.synchronize()
                kept = {"state_bytes": state_bytes(runner),
                        "memory_allocated": torch.cuda.memory_allocated()}
            if runner.state.step % SH_ACC == 0:
                torch.cuda.synchronize()
                peak = max(peak, torch.cuda.max_memory_allocated())
                with runner.full_weights():  # outside the peak
                    after.append(flat())
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
    launches = kernel_launches()
    if tag == "fsdp":  # (d) samples from it
        from bbdm_tpu_torch.checkpoints.io import save_checkpoint

        with runner.full_weights():
            if runner.is_main:
                ckpt = runner.config.result.ckpt_path
                for name_, states in zip(("last_model.ckpt", "last_optim_sche.ckpt"),
                                         runner.get_checkpoint_states()):
                    save_checkpoint(states, os.path.join(ckpt, name_))
                del states
    dp_dump(out, name, rank, ranks, {
        "launches": launches, "losses": losses, "lrs": lrs, "rows": int(x.shape[0]),
        "grid": [runner.grid.data_size, runner.grid.model_size], "peak_memory": peak, **kept,
        "ckpt": runner.config.result.ckpt_path, "after": tuple(after)})


def sh_jobs(rank, ranks, dev, jobs):
    """Every 2-rank run of a phase (10 or 11) in one spawn: ``job(rank, ranks,
    dev, *args)`` for each (job, args) in turn; each runner makes its grid."""
    for job, args in jobs:
        job(rank, ranks, dev, *args)
        torch.cuda.empty_cache()


def sharding_phase(dev, root, configs=None, setup=None, pairs=DP_PAIRS):
    """Phase 11 (see the module docstring): (a)-(d). ``configs`` ({"lbbdm",
    "vqgan"} ConfigNodes) and ``setup`` let a CPU rehearsal pass tiny models
    and its stubs to the spawned ranks. The one-rank runs come first, then one
    spawn of 2 ranks runs (a)-(d) in turn. Returns the phase's numbers."""
    import shutil

    import numpy as np

    from bbdm_tpu_torch.config import load_config, save_config

    here = os.path.dirname(os.path.abspath(__file__))
    load = lambda n: load_config(os.path.join(here, "configs", f"Template-{n}.yaml"))
    cfg = configs["lbbdm"] if configs else load("LBBDM-f4")
    size = cfg.data.dataset_config.image_size
    work = os.path.join(root, "sharding")
    data = os.path.join(work, "data")
    n_train, n_val, n_test = pairs
    write_dataset(data, size, n_test, seed=13, train=n_train, val=n_val)
    cfg.data.dataset_config.dataset_path = data
    cfg.model.VQGAN.params.ckpt_path = None  # seeded random, the same on every rank
    cfg.model.BB.params.sample_step = SAMPLE_STEP
    cfg.testing.sample_num = 1
    cfg.training.accumulate_grad_batches = SH_ACC
    paths = {}
    for tag, (fsdp, mp) in (("one", (False, 1)), ("fsdp", (True, 1)), ("tp", (False, 2))):
        cfg.training.fsdp, cfg.training.model_parallel = fsdp, mp
        paths[tag] = os.path.join(work, f"lbbdm-{tag}.yaml")
        save_config(cfg, paths[tag])
    # (d) samples from the checkpoint (a) writes
    ckpt = os.path.join(work, f"fsdp-{DP_RANKS}", cfg.data.dataset_name, cfg.model.model_name,
                        "checkpoint", "last_model.ckpt")
    spaths = {}
    for tag in ("one", "tp"):
        scfg = load_config(paths[tag])
        scfg.model.model_load_path = ckpt
        spaths[tag] = os.path.join(work, f"sample-{tag}.yaml")
        save_config(scfg, spaths[tag])
    vcfg = configs["vqgan"] if configs else load("VQGAN-f4")
    vdata = os.path.join(work, "data-vqgan")
    vbs = vcfg.data.train.batch_size
    write_single_dataset(vdata, vcfg.data.dataset_config.image_size,
                         (DP_VQ_STEPS * vbs, vbs, vbs), seed=14)
    vcfg.data.dataset_config.dataset_path = vdata
    vcfg.data.dataset_config.flip = False
    vcfg.model.loss.disc_start, vcfg.model.loss.perceptual_weight = 0, 0.0
    vcfg.model.loss.lpips_weights = None
    vruns = {"fsdp": ((True, 1), DP_VQ_STEPS), "tp": ((False, 2), 1)}
    vpaths = {}
    for tag, (sharded, _) in vruns.items():
        if tag == "tp":
            for split in ("train", "val", "test"):
                vcfg.data[split].batch_size = SH_TP_VQ_BATCH
        for ranks, (fsdp, mp) in ((1, (False, 1)), (DP_RANKS, sharded)):
            vcfg.training.fsdp, vcfg.training.model_parallel = fsdp, mp
            vpaths[tag, ranks] = os.path.join(work, f"vqgan-{tag}-{ranks}.yaml")
            save_config(vcfg, vpaths[tag, ranks])
    bs = cfg.data.train.batch_size
    log("reduced: " + json.dumps({
        "phase": "11 (a, b, d)", "microbatches": {"fsdp": SH_MICRO, "tp": SH_TP_MICRO},
        "accumulate_grad_batches": {"template": 4, "run": SH_ACC},
        "train/val/test pairs": list(pairs), "sample_step": {"template": 200, "run": SAMPLE_STEP},
        "sample_num": {"template": 5, "run": 1}, "weights": "random (seed), VQGAN too",
        "ranks": f"1 and {DP_RANKS} on card 0 (gloo)"}))
    out = {}

    def read(name, ranks):
        per_rank = []
        for r in range(ranks):
            with open(os.path.join(work, f"{name}_rank{r}_of{ranks}.json")) as f:
                per_rank.append(json.load(f))
        return torch.load(os.path.join(work, f"{name}_of{ranks}.pt")), per_rank

    def check_launches(what, per_rank, want):
        got = [r["launches"] for r in per_rank]
        log(f"  {what}: launches per rank {got}, derived from the code {want}")
        if any(g != want for g in got):
            raise AssertionError(f"{what}: launches {got} != {want}")

    # the one-rank runs, then one spawn of every 2-rank run, then (d)'s one-rank samples
    sh_train_job(0, 1, dev, paths["one"], work, "one")
    sh_train_job(0, 1, dev, paths["one"], work, "one", fp32=True)
    for tag, (_, steps) in vruns.items():
        dp_vqgan_job(0, 1, dev, vpaths[tag, 1], work, f"vqgan-{tag}", steps)
    torch.cuda.empty_cache()
    spawn_ranks(dev, sh_jobs, ([
        (sh_train_job, (paths["fsdp"], work, "fsdp", SH_MICRO)),
        (sh_train_job, (paths["tp"], work, "tp", SH_TP_MICRO)),
        *((dp_vqgan_job, (vpaths[tag, DP_RANKS], work, f"vqgan-{tag}", steps))
          for tag, (_, steps) in vruns.items()),
        (dp_sample_job, (spaths["tp"], work))],), setup)
    dp_sample_job(0, 1, dev, spaths["one"], work)
    dp_sample_job(0, 1, dev, spaths["one"], work, fp32=True)

    # (a) FSDP and (b) tensor parallelism, against 1 rank and 1 rank in fp32
    (one, one_r), (f32, _) = read("one", 1), read("one-fp32", 1)
    ab = {"1": {k: one_r[0][k] for k in ("state_bytes", "memory_allocated", "peak_memory")}}
    for tag, part, micro in (("fsdp", "a", SH_MICRO), ("tp", "b", SH_TP_MICRO)):
        n = micro // SH_ACC - 1  # the last update's parameters
        ref = {"loss_max_abs": max(abs(p - q) for p, q in
                                   zip(f32["losses"][:micro], one["losses"][:micro])),
               "param_max_abs": float((f32["after"][n] - one["after"][n]).abs().max())}
        two, two_r = read(tag, DP_RANKS)
        rows = two_r[0]["rows"]
        check_launches(f"({part}) {tag} train", two_r,
                       expected_launches(kernel_calls(cfg.model, rows), microbatches=micro))
        r = {"grid": two_r[0]["grid"], "rows_per_rank": rows, "microbatches": micro,
             "state_bytes": [x["state_bytes"] for x in two_r],
             "state_share": [x["state_bytes"] / one_r[0]["state_bytes"] for x in two_r],
             "memory_allocated": [x["memory_allocated"] for x in two_r],
             "peak_memory": [x["peak_memory"] for x in two_r],
             "loss_max_abs": max(abs(p - q) for p, q in zip(two["losses"], one["losses"])),
             "param_max_abs": float((two["after"][n] - one["after"][n]).abs().max()),
             "fp32_vs_1": ref, "launches": two_r[0]["launches"]}
        ab[tag] = r
        log(f"  ({part}) LBBDM-f4 train under {tag} on a {r['grid'][0]} x {r['grid'][1]} grid, "
            f"{micro} microbatches at node batch {bs}: " + json.dumps(r)
            + f"; 1 rank {json.dumps(ab['1'])}")
        if two["lrs"] != one["lrs"][:micro] or \
                [x["losses"] for x in two_r] != [two["losses"]] * DP_RANKS:
            raise AssertionError(f"({part}): lr differs from 1 rank, or the ranks' losses differ")
        for k in ("loss_max_abs", "param_max_abs"):
            if r[k] > 2 * ref[k]:
                raise AssertionError(f"({part}): {k} against 1 rank beyond twice bf16's "
                                     "distance from fp32")
        if tag == "fsdp" and max(r["state_share"]) > 0.55:
            raise AssertionError(f"(a): a rank keeps {r['state_share']} of one rank's state")
    out["train"] = ab
    del one, f32, two

    # (c) VQGAN-f4 in fp32: 2 steps under FSDP; 1 step under tensor
    # parallelism at node batch SH_TP_VQ_BATCH; each against 1 rank, codes pinned
    bars = VQ_STEP_BARS["norm_rel"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    norm_rel = lambda a, b: float((a - b).norm() / b.norm())
    vlr = float(vcfg.model.optimizer.lr)
    players = ("vqgan", "discriminator")
    c = {}
    for tag, (_, steps) in vruns.items():
        name = f"vqgan-{tag}"
        (one, one_r), (two, two_r) = read(name, 1), read(name, DP_RANKS)
        check_launches(f"(c) VQGAN train under {tag}, {DP_RANKS} ranks (each as 1 rank)",
                       two_r, one_r[0]["launches"])
        r = {"steps": steps, "node_batch": one_r[0]["rows"], "rows_per_rank": two_r[0]["rows"],
             "metrics_rel": {k: max(rel(p[k], q[k]) for p, q in
                                    zip(two["metrics"], one["metrics"]))
                             for k in ("loss", "d_loss", "d_weight")},
             "bn_stats_norm_rel": max(norm_rel(two["stats"][k], one["stats"][k])
                                      for k in one["stats"]),
             "grad_norm_rel": {n: norm_rel(two["grads"][n], one["grads"][n]) for n in players},
             "params_beyond_lr_10": {n: float(((two["after"][n] - one["after"][n]).abs()
                                               > vlr / 10).float().mean()) for n in players},
             "params_max_abs_over_lr": {n: float((two["after"][n] - one["after"][n]).abs()
                                                 .max()) / vlr for n in players},
             "code_flips": [x["code_flips"] for x in two_r], "launches": two_r[0]["launches"]}
        # Adam's first update from zero moments is lr * g / (|g| + eps): a
        # gradient within rounding of 0 moves its element anywhere in
        # [-lr, lr], so the parameters are held to 2 lr a step (and fp32's
        # rounding of it), the gradients to phase 7's bars
        r["bars"] = {"loss": bars["gen_loss"], "d_loss": bars["disc_grad"],
                     "d_weight": bars["gen_grad"], "bn_stats": bars["disc_grad"],
                     "vqgan": bars["gen_grad"], "discriminator": bars["disc_grad"],
                     "params_max_abs_over_lr": 2 * steps * (1 + 1e-4)}
        c[tag] = r
        log(f"  (c) VQGAN-f4 train under {tag}, {steps} step(s) at node batch "
            f"{r['node_batch']}, {DP_RANKS} ranks against 1: " + json.dumps(r))
        over = [k for k in ("loss", "d_loss", "d_weight") if r["metrics_rel"][k] > r["bars"][k]]
        over += ["bn_stats"] * (r["bn_stats_norm_rel"] > r["bars"]["bn_stats"])
        over += [f"{n} gradient" for n in players if r["grad_norm_rel"][n] > r["bars"][n]]
        over += [f"{n} params_max_abs_over_lr" for n in players
                 if r["params_max_abs_over_lr"][n] > r["bars"]["params_max_abs_over_lr"]]
        if over:
            raise AssertionError(f"(c) {tag}: {over} beyond their bars")
    out["vqgan_train"] = c

    # (d) --sample_to_eval of the test pairs from (a)'s checkpoint: 2 ranks on
    # the 1 x 2 grid (both sample every row, model index 0 writes) against 1
    # rank, and 1 rank in fp32 through the twins
    trees = {k: read_pngs(read(n, r)[0]["tree"]) for k, (n, r) in {
        "1": ("sample", 1), "fp32": ("sample-fp32", 1), "2": ("sample", DP_RANKS)}.items()}
    want = expected_launches(kernel_calls(cfg.model, cfg.data.test.batch_size),
                             steps=SAMPLE_STEP, draws=1,
                             batches=n_test // cfg.data.test.batch_size)
    for ranks in (1, DP_RANKS):
        check_launches(f"(d) sample_to_eval, {ranks} rank(s)", read("sample", ranks)[1], want)
    names = [f"{i:04d}" for i in range(n_test)]
    check_tree(read("sample", DP_RANKS)[0]["tree"], names, names, SAMPLE_STEP, 1, size)
    if sorted(trees["2"]) != sorted(trees["1"]):
        raise AssertionError("(d): the trees hold other files")
    diff = lambda k: np.stack([np.abs(trees[k][p].astype(int) - trees["1"][p])
                               for p in sorted(trees["1"]) if p.startswith(str(SAMPLE_STEP))])
    d = {"codes_max": {f"{DP_RANKS}_vs_1": int(diff("2").max()),
                       "fp32_vs_1": int(diff("fp32").max())},
         "codes_mean": {f"{DP_RANKS}_vs_1": float(diff("2").mean()),
                        "fp32_vs_1": float(diff("fp32").mean())},
         "inputs_equal": all(np.array_equal(trees["2"][p], trees["1"][p]) for p in trees["1"]
                             if not p.startswith(str(SAMPLE_STEP))),
         "launches": read("sample", DP_RANKS)[1][0]["launches"]}
    out["sample_to_eval"] = d
    log(f"  (d) sample_to_eval of (a)'s checkpoint, {n_test} pairs, {DP_RANKS} ranks on a "
        "1 x 2 grid against 1 rank, in uint8 codes, beside bf16 against fp32: " + json.dumps(d))
    if not d["inputs_equal"] or d["codes_mean"][f"{DP_RANKS}_vs_1"] > \
            2 * d["codes_mean"]["fp32_vs_1"]:
        raise AssertionError("(d): the samples differ from 1 rank's by more than twice bf16's "
                             "mean distance from fp32, or the copied inputs differ")
    shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------- data layer

DATA_TRAIN, DATA_VAL, DATA_TEST, DATA_EPOCHS = 64, 8, 8, 2  # 256^2 Paeth PNGs; flipped: 128
FIXTURES = os.path.join("tests", "data", "torch_images")


def fixture_arrays(root, sub=""):
    """The committed fixtures' expected arrays and digests (``make_fixtures.py``;
    ``sub="webp"``: ``webp/make_webp_fixtures.py``)."""
    import numpy as np

    with np.load(os.path.join(root, FIXTURES, sub, "expected.npz")) as z:
        return {k: z[k].tobytes() if k.startswith("sha256:") else
                np.cumsum(z[k], axis=1, dtype=np.uint8) for k in z.files}


def codec_checks(root):
    """{fixture directory: fixtures checked}: every committed fixture decoded
    against its stored array or digest (LAB, WebP, WebP as ``cv2.imread`` too)."""
    import hashlib

    from bbdm_tpu_torch.data.colors import rgb_to_lab
    from bbdm_tpu_torch.utils.images import read_image

    checked = {}
    for sub in ("", "webp"):
        fdir = os.path.join(root, FIXTURES, sub)
        checked[sub or "png_jpeg_bmp"] = 0
        for key, arr in sorted(fixture_arrays(root, sub).items()):
            kind, _, name = key.rpartition(":")
            got = read_image(os.path.join(fdir, name), imread=kind in ("lab", "imread"))
            if kind == "sha256":
                ok = hashlib.sha256(got.tobytes()).digest() == arr
            else:
                ok = (rgb_to_lab(got) if kind == "lab" else got).tobytes() == arr.tobytes() \
                    and got.shape == arr.shape
            if not ok:
                raise AssertionError(f"fixture {sub}/{key}: decoded array differs from the "
                                     "stored one")
            checked[sub or "png_jpeg_bmp"] += 1
    return checked


def write_paeth_tree(root, size, counts, seed):
    """``<stage>/<i>.png`` (train, val, test), every row filtered Paeth."""
    for stage, n in zip(("train", "val", "test"), counts):
        os.makedirs(os.path.join(root, stage), exist_ok=True)
        for i in range(n):
            write_filtered_png(os.path.join(root, stage, f"{i:04d}.png"),
                               textured_u8(size, seed + 100 * len(stage) + i), (4,))


def vqgan_checkpoint(cfg, dev, path):
    """A seeded random VQGAN for ``cfg``'s LBBDM, saved alone."""
    from bbdm_tpu_torch.checkpoints.from_jax import jax_tree_from_state_dict
    from bbdm_tpu_torch.checkpoints.io import save_checkpoint
    from bbdm_tpu_torch.models import build_model

    m = build_model(cfg.model, device=dev, generator=torch.Generator(dev).manual_seed(21))
    save_checkpoint({"vqgan": jax_tree_from_state_dict(m)["vqgan"]}, path)
    del m


@contextlib.contextmanager
def cache_logs(store):
    """The lines ``maybe_device_cache`` logs in the block, in ``store``."""
    from bbdm_tpu_torch.data import device_cache

    def recorded(fn):
        def wrapped(loader, training, world, device, logger=print, resident=None):
            def log_line(msg):
                store.append(msg)
                logger(msg)
            return fn(loader, training, world, device, log_line, resident=resident)
        return wrapped

    with patched(device_cache, "maybe_device_cache", recorded):
        yield store


@contextlib.contextmanager
def cache_builds(store):
    """Each ``device_cache.Resident`` built in the block: (items, bytes,
    dtype), in ``store``."""
    from bbdm_tpu_torch.data import device_cache

    def recorded(init):
        def wrapped(self, dataset, device, *a, **kw):
            init(self, dataset, device, *a, **kw)
            store.append({"items": len(self.x_names), "bytes": self.nbytes,
                          "dtype": str(self.dtype)})
        return wrapped

    with patched(device_cache.Resident, "__init__", recorded):
        yield store


def device_cache_checks(dev, counters, work, tree, runner):
    """Phase 12 (d): ``training.device_data_cache`` on LBBDM-f4 training over the
    Paeth tree as ``custom_aligned`` (its images as both sides: 64 items a
    stream, 8 microbatches an epoch), on ``runner`` (part (b)'s, reconfigured):
    the cached batches against ``_put_batch`` of the host loader's, bit for
    bit, over an epoch; the latent-statistics pass with the resident copy
    against the host loader's; then one epoch of ``BaseRunner.train`` through
    the host loader as the template configures it (no ``cache_in_ram``) and
    one through the cache: each epoch's steps and launches against
    :func:`kernel_calls`, the caches built and the lines logged."""
    from bbdm_tpu_torch.data.base import clear_image_cache
    from bbdm_tpu_torch.data.device_cache import DeviceCachedLoader

    aligned = os.path.join(work, "aligned-paeth")
    for stage in ("train", "val", "test"):
        for side in ("A", "B"):
            os.makedirs(os.path.join(aligned, stage), exist_ok=True)
            os.symlink(os.path.abspath(os.path.join(tree, stage)),
                       os.path.join(aligned, stage, side))
    cfg = runner.config
    cfg.data.dataset_type = "custom_aligned"
    d = cfg.data.dataset_config
    d.dataset_path, d.flip, d.cache_in_ram = aligned, False, False
    clear_image_cache()
    training = cfg.training
    training.validation_interval, training.sample_interval = 1, 1000
    out = {"items_per_stream": DATA_TRAIN, "epochs": {}, "cache_builds": []}

    # bit for bit: the cached batches against _put_batch of the host batches
    training.device_data_cache = False
    host = runner._build_loaders()[0]
    training.device_data_cache = True
    with cache_builds(out["cache_builds"]):
        cached = runner._build_loaders()[0]
    if not isinstance(cached, DeviceCachedLoader):
        raise AssertionError("device cache: the runner built no cache")
    host.set_epoch(0)
    cached.set_epoch(0)
    equal, n = 0, 0
    for hb, cb in zip(host, cached):
        a, b = runner._put_batch(hb), runner._put_batch(cb)
        n += 1
        equal += all(torch.equal(x, y) and x.stride() == y.stride() for x, y in zip(a, b))
    out["batches_equal"] = [equal, n]
    log(f"  (d) device cache: {equal} of {n} cached batches equal _put_batch of the host "
        f"loader's bit for bit (layout included); built {json.dumps(out['cache_builds'])}")
    if equal != n or n != len(host) or n == 0:
        raise AssertionError(f"device cache: {equal} of {n} batches equal the host path's")

    # the latent-statistics pass: the host loader, then the resident copy
    stats = []
    for cache in (False, True):
        training.device_data_cache = cache
        runner.get_latent_mean_std()
        stats.append({k: v.detach().clone() for k, v in runner.latent_stats.items()})
    dev_max = max(float((stats[1][k] - stats[0][k]).abs().max()) for k in stats[0])
    out["latent_stats_max_abs_vs_host"] = dev_max
    runner._resident.clear()
    del host, cached
    if dev_max > 1e-5:
        raise AssertionError(f"device cache: latent statistics {dev_max} from the host path's")

    # one epoch of BaseRunner.train through the host loader, one through the cache
    bs = cfg.data.train.batch_size
    micro = DATA_TRAIN // bs
    val_batches = DATA_VAL // cfg.data.val.batch_size
    calls = kernel_calls(cfg.model, bs)
    steps_run = []

    def counted_step(build):
        def build_counted():
            step = build()

            def counted(*a, **kw):
                steps_run.append(1)
                return step(*a, **kw)
            return counted
        return build_counted

    logs = []
    for label, cache in (("host", False), ("cache", True)):
        training.device_data_cache = cache
        training.n_epochs = runner.global_epoch + 1
        for mod, attr in counters.values():
            getattr(mod, attr).launches = 0
        steps_run.clear()
        builds = []
        steps = range(runner.global_step + 1, runner.global_step + micro + 1)
        want = expected_launches(calls, microbatches=micro + val_batches
                                 + sum(g % 50 == 0 for g in steps))  # validation steps
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(runner, "build_train_step", counted_step))
            for attr, stub in (("get_checkpoint_states", ({}, {})),
                               ("_save_checkpoints", None)):
                stack.enter_context(patched(runner, attr,
                                            lambda fn, stub=stub: lambda *a, **kw: stub))
            stack.enter_context(patched(runner, "logger", lambda fn: lambda m: (
                logs.append(m) if "device_data_cache" in str(m) else None, fn(m))))
            stack.enter_context(cache_builds(builds))
            runner.train()
        launches = {SHORT[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
        if launches != want or len(steps_run) != micro:
            raise AssertionError(f"device cache, {label} epoch: launches {launches} != {want}"
                                 f" or {len(steps_run)} microbatches, not {micro}")
        out["epochs"][label] = {"cache_builds": builds, "launches": launches}
    out["logged"] = logs
    log(f"  (d) LBBDM-f4 train on the Paeth tree as custom_aligned, {micro} microbatches an "
        f"epoch, through the host loader, then the device cache: " + json.dumps(out["epochs"])
        + f"; latent statistics from the cache within {dev_max:.3g} of the host's; logged {logs}")
    if len(logs) != 2 or [len(e["cache_builds"]) for e in out["epochs"].values()] != [0, 2]:
        raise AssertionError(f"device cache: builds or log lines wrong: {logs}")
    return out


def data_phase(dev, counters, root, gpu_ids="0", config=None, lab_config=None,
               aligned_config=None):
    """Phase 12 (see the module docstring): the host codec, LBBDM-f4 training on
    a ``custom_inpainting`` Paeth tree under ``cache_in_ram``,
    ``--sample_to_eval`` from a ``custom_colorization_LAB`` tree of the JPEG
    fixtures and from a ``custom_aligned`` tree of WebP files, through
    ``main_torch.main``, and the device cache (:func:`device_cache_checks`, on
    part (b)'s runner). ``config``/``lab_config``/``aligned_config`` let a CPU
    rehearsal pass tiny models."""
    import shutil

    import numpy as np

    import main_torch
    from bbdm_tpu_torch.config import load_config, save_config
    from bbdm_tpu_torch.data import base, custom, loader
    from bbdm_tpu_torch.runners import base as runner_base

    here = os.path.dirname(os.path.abspath(__file__))
    out = {"fixtures_checked": codec_checks(here)}
    log(f"  (a) codec: stored fixture arrays equal {json.dumps(out['fixtures_checked'])}")

    work = os.path.join(root, "data-phase")
    template = os.path.join(here, "configs", "Template-LBBDM-f4.yaml")
    cfg = config or load_config(template)
    size = cfg.data.dataset_config.image_size
    tree = os.path.join(work, "paeth")
    write_paeth_tree(tree, 256, (DATA_TRAIN, DATA_VAL, DATA_TEST), seed=12)

    # (b) training through main_torch.main, cache_in_ram on
    d = cfg.data.dataset_config
    cfg.data.dataset_type = "custom_inpainting"
    d.dataset_path, d.flip, d.cache_in_ram = tree, True, True
    cfg.model.VQGAN.params.ckpt_path = os.path.join(work, "vqgan.ckpt")
    vqgan_checkpoint(cfg, dev, cfg.model.VQGAN.params.ckpt_path)
    t = cfg.training
    t.sample_interval, t.save_interval, t.validation_interval = 1000, DATA_EPOCHS, DATA_EPOCHS
    path = os.path.join(work, "train.yaml")
    save_config(cfg, path)
    bs = cfg.data.train.batch_size
    micro_per_epoch = 2 * DATA_TRAIN // bs
    calls = kernel_calls(cfg.model, bs)
    log("reduced: " + json.dumps({
        "n_epochs": {"template": 100, "run": DATA_EPOCHS}, "microbatches": DATA_EPOCHS
        * micro_per_epoch, "train/val/test images": [DATA_TRAIN, DATA_VAL, DATA_TEST],
        "dataset_type": "custom_inpainting (template: custom_aligned)", "flip": True,
        "cache_in_ram": True, "sample_interval": "none during training",
        "weights": "random UNet (seed), a smoke-made VQGAN (seed 21)"}))

    # the image decodes started before each train epoch's set_epoch and before
    # the validation epoch mark the epochs' bounds in the list of decodes
    marks = {"epoch": [], "val": [], "decodes": [], "served": [], "bad": []}

    def on_set_epoch(fn):
        def wrapped(self, epoch):
            if isinstance(self.dataset, custom.CustomInpaintingDataset) and self.dataset.flip:
                marks["epoch"].append((len(marks["decodes"]), int(epoch)))
            return fn(self, epoch)
        return wrapped

    def on_validation(fn):
        def wrapped(*a, **kw):
            marks["val"].append(len(marks["decodes"]))
            return fn(*a, **kw)
        return wrapped

    def counted_load(fn):
        def wrapped(*a, **kw):
            marks["decodes"].append(1)
            return fn(*a, **kw)
        return wrapped

    def checked_item(fn):
        def wrapped(self, index):
            item = fn(self, index)
            (x, _), (cond, _) = item
            if self.flip:  # the train set: the box must follow the epoch's seed
                rng = np.random.RandomState((self.mask_seed * 1_000_003 + index) % (2 ** 31))
                mw, mh = rng.randint(128, 181), rng.randint(128, 181)
                top, left = rng.randint(0, size - mh + 1), rng.randint(0, size - mw + 1)
                inside = np.zeros(x.shape[:2], bool)
                inside[top:top + mh, left:left + mw] = True
                if (cond[inside] != 0).any() or not np.array_equal(cond[~inside], x[~inside]):
                    marks["bad"].append((index, self.mask_seed))
                marks["served"].append((index, self.mask_seed))
            return item
        return wrapped

    for mod, attr in counters.values():
        getattr(mod, attr).launches = 0
    base.clear_image_cache()
    result = os.path.join(work, "results-train")
    argv = ["-c", path, "--train", "--max_epoch", str(DATA_EPOCHS), "-r", result, "-s",
            str(CLI_SEED), "--gpu_ids", gpu_ids]
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(loader.DataLoader, "set_epoch", on_set_epoch))
        stack.enter_context(patched(runner_base.BaseRunner, "validation_epoch", on_validation))
        stack.enter_context(patched(base, "_load_image", counted_load))
        stack.enter_context(patched(custom.CustomInpaintingDataset, "__getitem__", checked_item))
        runner = main_torch.main(argv)
    launches = {SHORT[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
    micro = DATA_EPOCHS * micro_per_epoch
    val_batches = DATA_VAL // cfg.data.val.batch_size
    want = expected_launches(calls, microbatches=micro + val_batches)
    if runner.global_step != micro:
        raise AssertionError(f"data train: {runner.global_step} steps, not {micro}")
    if launches != want:
        raise AssertionError(f"data train: launches {launches} != {want} (kernel_calls)")
    if [e for _, e in marks["epoch"]] != list(range(DATA_EPOCHS)) or len(marks["val"]) != 1:
        raise AssertionError(f"data train: epochs {marks['epoch']}, validations {marks['val']}")
    bounds = [n for n, _ in marks["epoch"]] + marks["val"]
    decodes = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    seeds = sorted({sd for _, sd in marks["served"]})
    out["train"] = {"launches": launches, "expected_launches": want,
                    "decodes_per_epoch": decodes, "served_items": len(marks["served"]),
                    "mask_seeds": seeds, "bad_masks": len(marks["bad"]),
                    "checkpoint": sorted(os.listdir(runner.config.result.ckpt_path))}
    log(f"  (b) data train (main_torch --train, custom_inpainting, cache_in_ram): {micro} "
        f"microbatches, launches {launches} (kernel_calls: {want}); image decodes per epoch "
        f"{decodes}; {len(marks['served'])} served train items checked against the box rule "
        f"for seeds {seeds}: {len(marks['bad'])} wrong")
    if marks["bad"] or seeds != [CLI_SEED + e for e in range(DATA_EPOCHS)] \
            or len(marks["served"]) != micro * bs:
        raise AssertionError("data train: the served masks do not follow the epoch seeds")
    if decodes[0] != 2 * DATA_TRAIN or any(decodes[1:]):
        raise AssertionError(f"data train: decodes per epoch {decodes}, "
                             f"expected {2 * DATA_TRAIN} then 0 (cache_in_ram)")
    ckpt = os.path.join(runner.config.result.ckpt_path, "last_model.ckpt")
    out["device_cache"] = device_cache_checks(dev, counters, work, tree, runner)
    del runner
    torch.cuda.empty_cache()

    # (c) --sample_to_eval from that checkpoint over a LAB tree of the JPEG
    # fixtures and over a custom_aligned tree of WebP pairs
    def sample_to_eval(key, label, c, kind, tree, names):
        c.data.dataset_type = kind
        c.data.dataset_config.dataset_path = tree
        c.model.VQGAN.params.ckpt_path = cfg.model.VQGAN.params.ckpt_path
        c.model.BB.params.sample_step = SAMPLE_STEP
        c.testing.sample_num = 1
        path = os.path.join(work, f"{key}.yaml")
        save_config(c, path)
        for mod, attr in counters.values():
            getattr(mod, attr).launches = 0
        runner = main_torch.main(["-c", path, "--sample_to_eval", "--resume_model", ckpt, "-r",
                                  os.path.join(work, f"results-{key}"), "-s", str(CLI_SEED),
                                  "--gpu_ids", gpu_ids])
        launches = {SHORT[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
        want = expected_launches(kernel_calls(c.model, bs), steps=len(runner.model.coeffs.steps),
                                 draws=1, batches=1)
        check_tree(runner.config.result.sample_to_eval_path, names, names, SAMPLE_STEP, 1,
                   c.data.dataset_config.image_size)
        out[f"{key}_sample_to_eval"] = {"launches": launches, "expected": want, "names": names}
        log(f"  (c) {label} --sample_to_eval ({SAMPLE_STEP} steps, 1 draw): launches "
            f"{launches} (kernel_calls: {want}), tree checked")
        if launches != want or min(launches.values()) <= 0:
            raise AssertionError(f"{label} sample_to_eval: launches {launches} != {want}")

    bs = cfg.data.test.batch_size
    jpegs = sorted(f for f in os.listdir(os.path.join(here, FIXTURES)) if f.endswith(".jpg"))
    lab_tree = os.path.join(work, "lab")
    for stage in ("train", "val", "test"):
        os.makedirs(os.path.join(lab_tree, stage))
        for f in jpegs[:bs]:
            shutil.copy(os.path.join(here, FIXTURES, f), os.path.join(lab_tree, stage, f))
    sample_to_eval("lab", f"LAB ({bs} JPEG fixtures)", lab_config or load_config(template),
                   "custom_colorization_LAB", lab_tree,
                   [os.path.splitext(f)[0] for f in jpegs[:bs]])
    src = os.path.join(here, FIXTURES, "webp", "tree256")
    webps = sorted(os.listdir(src))[:bs]
    aligned_tree = os.path.join(work, "aligned-webp")
    for stage in ("train", "val", "test"):
        for side, shift in (("A", 0), ("B", 1)):
            os.makedirs(os.path.join(aligned_tree, stage, side))
            for i, f in enumerate(webps):
                shutil.copy(os.path.join(src, webps[(i + shift) % len(webps)]),
                            os.path.join(aligned_tree, stage, side, f))
    sample_to_eval("webp", f"WebP ({bs} custom_aligned VP8 q85 pairs)",
                   aligned_config or load_config(template), "custom_aligned", aligned_tree,
                   [os.path.splitext(f)[0] for f in webps])
    shutil.rmtree(work, ignore_errors=True)
    return out


# ------------------------------------------------------------------ tools

TOOLS_STEPS, TOOLS_HEUN_STEPS, TOOLS_BENCH_CALLS, TOOLS_TRAIN_STEPS = 200, 20, 4, 11
# of |x0| + |y| + sigma_t |noise|, elementwise: twice the bound (2^-8 relative) of the
# inputs' bf16 rounding
Q_SAMPLE_BAR = 2.0 ** -7
BERT_WIDTH, BERT_LAYERS, BERT_TOKENS = 1280, 32, 77  # LDM txt2img-1p4B's BERTEmbedder
BERT_REL_BAR = 3e-2  # bf16 vs fp32, relative Frobenius; the CPU at depth 32, width 256: 1.3e-2
BERT_TEXTS = ["a photograph of an astronaut riding a horse", "The cats sat, unaffable!",
              "zebra crossing [SEP] at night", "Café au lait, naïve résumé",
              "中文 and English mixed", "", "one two three " * 40,
              "a painting of a lighthouse in a storm"]


def run_tool(argv, env):
    """One tool as its own process from the checkout's root: its output lines
    logged, the JSON object of its last line returned; a non-zero exit raises."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable] + argv, cwd=here, env=env, capture_output=True,
                          text=True, timeout=900)
    for line in proc.stdout.strip().splitlines():
        log("    " + line)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"{' '.join(argv)} exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def dtype_calls(seen):
    """Count K2's and K3's launches by dtype in ``seen`` (the fp32 entries go
    through ``_upconv_f32``/``_flash_f32``, the bf16 ones through
    ``_upconv_bf16``/``_flash_bf16``)."""
    from bbdm_tpu_torch.ops import attention, upsample_conv

    saved = []
    for mod, key, attr in ((upsample_conv, ("K2", "fp32"), "_upconv_f32"),
                           (upsample_conv, ("K2", "bf16"), "_upconv_bf16"),
                           (attention, ("K3", "fp32"), "_flash_f32"),
                           (attention, ("K3", "bf16"), "_flash_bf16")):
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def counted(*a, _fn=fn, _key=key, **kw):
            seen[_key] = seen.get(_key, 0) + 1
            return _fn(*a, **kw)

        setattr(mod, attr, counted)
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def write_vocab(path):
    """A WordPiece vocabulary: the specials, letters, digits and their ``##``
    pieces, punctuation, a few words and CJK characters (ids < 200)."""
    letters = "abcdefghijklmnopqrstuvwxyz0123456789"
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "the", "cat", "##s", "at",
             "photo", "##graph", "of", "an", "astronaut", "horse", "painting", "light",
             "##house", "in", "storm", "night", "one", "two", "three", "cafe", "au", "lait",
             "naive", "resume", "and", "english", "mixed", "中", "文", "zebra", "crossing"]
    toks = words + list(letters) + ["##" + c for c in letters] + list(",.!?;:'\"()[]-")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(toks) + "\n")


def tools_phase(dev, root, tree, config_path, vqgan_path, template=None,
                bench_env=None, steps=TOOLS_STEPS, heun_steps=TOOLS_HEUN_STEPS,
                bert=(BERT_WIDTH, BERT_LAYERS)):
    """Phase 13 (see the module docstring): the benches and the tools over phase
    5's ``sample_to_eval`` tree ``tree``, its config ``config_path`` and VQGAN
    ``vqgan_path``. ``template``, ``bench_env``, ``steps``, ``heun_steps`` and
    ``bert`` let a CPU rehearsal pass a tiny model (on the CPU the benches'
    subprocesses launch no kernel and their counts are not checked)."""
    import numpy as np

    from bbdm_tpu_torch.config import load_config
    from bbdm_tpu_torch.models import build_model
    from bbdm_tpu_torch.models.cond import BERTEmbedder
    from bbdm_tpu_torch.models.layers import init_parameters
    from bbdm_tpu_torch.tools import sampler_sweep, vqgan_recon
    from bbdm_tpu_torch.utils.flops import sampling_flops_per_image, training_flops_per_image

    here = os.path.dirname(os.path.abspath(__file__))
    template = template or os.path.join(here, "configs", "Template-LBBDM-f4.yaml")
    on_card = dev.type == "cuda"
    cpu = [] if on_card else ["--cpu"]
    out, by_path = {}, {}

    def check_launches(label, got, want, needed=("K1", "K2", "K3")):
        by_path[label] = got
        log(f"  {label}: launches {got}, expected {want}")
        if got != want or not all(want[k] > 0 for k in needed):
            raise AssertionError(f"{label}: launches {got}, expected {want} (kernel_calls), "
                                 f"each of {needed} at least once")

    # (a, b) the sampling bench, euler at full depth and heun; (c) the train bench
    cfg = load_config(template)
    batch = cfg.data.test.batch_size
    calls = kernel_calls(cfg.model, batch)
    env = dict(os.environ, PYTHONPATH=here, BENCH_CONFIG=template, BENCH_BATCH=str(batch),
               **(bench_env or {}))
    for label, sampler, n_steps in (("bench_euler", "euler", steps),
                                    ("bench_heun", "heun", heun_steps)):
        line = run_tool(["bench_torch.py"], dict(env, BENCH_STEPS=str(n_steps),
                                                 BENCH_SAMPLER=sampler))
        d = line["detail"]
        run_cfg = load_config(template).model
        run_cfg.BB.params.sample_step, run_cfg.BB.params.sampler = n_steps, sampler
        if d["flops_per_sample"] != sampling_flops_per_image(run_cfg):
            raise AssertionError(f"{label}: flops_per_sample {d['flops_per_sample']} is not the "
                                 "port's sampling_flops_per_image")
        if not np.isfinite(d["output_mean"]) or line["value"] <= 0:
            raise AssertionError(f"{label}: output mean {d['output_mean']}, {line['value']}/s")
        nfe = 2 * (n_steps - 1) + 1 if sampler == "heun" else n_steps
        if on_card:
            check_launches(label, d["launches"], expected_launches(
                calls, steps=nfe, draws=1, batches=TOOLS_BENCH_CALLS))
        out[label] = line
    line = run_tool(["-m", "bbdm_tpu_torch.tools.bench_train"], env)
    d = line["detail"]
    if d["flops_per_image"] != training_flops_per_image(load_config(template).model):
        raise AssertionError("bench_train: flops_per_image is not training_flops_per_image")
    if not np.isfinite(d["loss"]):
        raise AssertionError(f"bench_train: loss {d['loss']}")
    if on_card:
        check_launches("bench_train", d["launches"],  # training runs no K2 (naive up-conv)
                       expected_launches(calls, microbatches=TOOLS_TRAIN_STEPS), ("K1", "K3"))
    out["bench_train"] = line

    # (e) the VQGAN roundtrip over phase 5's ground truth, bf16 and fp32
    gt = os.path.join(tree, "ground_truth")
    images = len(os.listdir(gt))
    p5 = load_config(config_path)
    recon_calls = kernel_calls(p5.model, p5.data.test.batch_size)
    for fp32 in (False, True):
        label = "vqgan_recon_" + ("fp32" if fp32 else "bf16")
        kernel_launches(reset=True)
        seen = {}
        with dtype_calls(seen):
            line = vqgan_recon.main(
                ["--config", config_path, "--vq-ckpt", vqgan_path, "--data", gt,
                 "--out", os.path.join(root, label), "--batch",
                 str(p5.data.test.batch_size)] + (["--fp32"] if fp32 else []) + cpu)
        if line["count"] != images or not np.isfinite(line["psnr"]):
            raise AssertionError(f"{label}: {line}")
        check_launches(label, kernel_launches(), expected_launches(
            recon_calls, draws=1, batches=images // p5.data.test.batch_size))
        if on_card:
            want = {(k, "fp32" if fp32 else "bf16"): by_path[label][k] for k in ("K2", "K3")}
            log(f"  {label}: K2/K3 launches by dtype {seen}")
            if seen != want:
                raise AssertionError(f"{label}: launches by dtype {seen} != {want}")
        line["launches_by_dtype"] = {f"{k}_{dt}": n for (k, dt), n in seen.items()}
        out[label] = line

    # (f) the sampler sweep from a seeded bridge checkpoint, then its resume
    bridge = os.path.join(root, "tools-bridge.ckpt")
    write_checkpoints(p5, dev, bridge)
    argv = ["--lbbdm-config", config_path, "--vq-ckpt", vqgan_path, "--bridge-ckpt", bridge,
            "--variants", f"euler:{steps // 10},heun:{steps // 20}",
            "--result", os.path.join(root, "sweep")] + cpu
    batches = len(os.listdir(gt)) // p5.data.test.batch_size
    kernel_launches(reset=True)
    rows = sampler_sweep.main(argv)
    want = {k: a + b for (k, a), b in zip(
        expected_launches(recon_calls, steps=steps // 10, draws=1, batches=batches).items(),
        expected_launches(recon_calls, steps=2 * (steps // 20 - 1) + 1, draws=1,
                          batches=batches).values())}
    check_launches("sampler_sweep", kernel_launches(), want)
    if [(r["sampler"], r["nfe"]) for r in rows] != [("euler", steps // 10),
                                                    ("heun", 2 * (steps // 20 - 1) + 1)]:
        raise AssertionError(f"sampler sweep rows {rows}")
    kernel_launches(reset=True)
    again = sampler_sweep.main(argv)
    if again != json.loads(json.dumps(rows, default=float)) or any(kernel_launches().values()):
        raise AssertionError("sampler sweep: the second invocation did not skip both variants")
    os.remove(bridge)
    out["sampler_sweep"] = {"rows": rows}

    # (g) q_sample_loop at the latent of phase 5's config, bf16 against its fp32 self
    model = build_model(p5.model, device=dev)
    dd = p5.model.VQGAN.params.ddconfig
    side = dd.resolution // 2 ** (len(dd.ch_mult) - 1)
    g = torch.Generator(dev).manual_seed(13)
    x0, y = (torch.randn((batch, dd.z_channels, side, side), generator=g, device=dev)
             for _ in range(2))
    noise = torch.randn((model.num_timesteps,) + x0.shape, generator=g, device=dev)

    def loop(dt):
        return model.q_sample_loop(x0.to(dt), y.to(dt), noise=noise)

    ref, low = loop(torch.float32), loop(torch.bfloat16)
    sigma = torch.sqrt(model._variance_t).view(-1, 1, 1, 1, 1)
    bar = Q_SAMPLE_BAR * (x0.abs() + y.abs() + sigma * noise.abs())
    excess = float(((low - ref).abs() / bar).max())
    drawn = model.q_sample_loop(x0.bfloat16(), y.bfloat16(), generator=g)
    out["q_sample_loop"] = {"shape": list(ref.shape), "bf16_vs_fp32_over_bar": excess,
                            "max_abs": float((low - ref).abs().max())}
    log(f"  q_sample_loop {list(ref.shape)}: bf16 vs fp32 max |d| "
        f"{out['q_sample_loop']['max_abs']:.3g} = {excess:.3f} of the bar")
    if excess > 1 or drawn.shape != ref.shape or not torch.isfinite(drawn).all():
        raise AssertionError("q_sample_loop: bf16 beyond its bar, or a non-finite draw")
    del model, ref, low, noise, drawn, bar

    # (h) BERTEmbedder at LDM txt2img's width, bf16 against fp32, tokens from a vocabulary
    vocab = os.path.join(root, "bert-vocab")
    write_vocab(vocab)
    width, depth = bert
    m32 = BERTEmbedder(width, depth, device=dev)
    init_parameters(m32, torch.Generator(dev).manual_seed(14))
    m16 = BERTEmbedder(width, depth, dtype=torch.bfloat16, device=dev)
    m16.load_state_dict(m32.state_dict())
    tokens = m32.tokenize(BERT_TEXTS, vocab)
    with torch.no_grad():
        a, b = m32.eval()(tokens), m16.eval()(tokens)
    rel = float((b - a).norm() / a.norm())
    out["bert_embedder"] = {"width": width, "layers": depth, "tokens": list(tokens.shape),
                            "rel_fro_bf16_vs_fp32": rel,
                            "max_abs": float((b - a).abs().max()),
                            "max_ref": float(a.abs().max())}
    log(f"  BERTEmbedder {width} x {depth} on tokens {list(tokens.shape)}: bf16 vs fp32 "
        f"relative {rel:.4f} (bar {BERT_REL_BAR})")
    if tokens.shape != (len(BERT_TEXTS), BERT_TOKENS) or not torch.isfinite(b).all() \
            or rel > BERT_REL_BAR:
        raise AssertionError("BERTEmbedder: bf16 beyond its bar or bad tokens")
    del m32, m16
    out["launches"] = by_path
    return out


# ------------------------------------------------------------ demonstrations

DEMO_PAIRS = (16, 8, 8)  # train, val, test pairs: the restore tree at 256^2, stochastic at 64^2
DEMO_WALL_S = 2.0  # the chain's --wall-a and --wall-b
DEMO_DRAWS = 5  # the chain's phase D (the reference protocol's sample_num)
DEMO_VARIANTS = "euler:20,heun:10"  # the pixel demo's phase S
DEMO_STOCH_VARIANT, DEMO_STOCH_DRAWS = ("euler", 20), 2


def demo_configs():
    """{name: ConfigNode} of the demonstrations' run configs (``configs/runs/``)."""
    from bbdm_tpu_torch.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    return {n: load_config(os.path.join(here, "configs", "runs", f"{n}.yaml"))
            for n in ("VQGAN-f4-syn256-v2", "LBBDM-f4-syn256-v2", "BBDM-synpix64",
                      "BBDM-synstoch64")}


def reference_pth(states, model_config, path):
    """A model checkpoint of the JAX package's layout (``states``) written as the
    reference repo's training ``.pth``: the UNet under ``denoise_fn.``, the VQGAN
    under ``vqgan.``, the EMA shadow of the UNet alone, NCHW latent statistics
    (the inverse of ``checkpoints/torch_import.convert_reference_checkpoint``)."""
    import re

    import numpy as np

    from bbdm_tpu_torch.checkpoints import torch_import as ti

    inverse = {ti._t_conv2d: lambda a: a.transpose(3, 2, 0, 1), ti._t_linear: lambda a: a.T,
               ti._t_conv1d: lambda a: a.T[:, :, None], ti._ident: lambda a: a}
    dense = {"weight": (("kernel",), ti._t_linear), "bias": (("bias",), ti._ident)}
    top = {"time_embed.0": ("time_dense_0", dense), "time_embed.2": ("time_dense_1", dense),
           "out.0": ("out_norm", {"weight": (("scale",), ti._ident),
                                  "bias": (("bias",), ti._ident)}),
           "out.2": ("out_conv", {"weight": (("kernel",), ti._t_conv2d),
                                  "bias": (("bias",), ti._ident)})}
    modules = dict(ti.unet_module_map(model_config.BB.params.UNetParams), **top)

    def unet(tree):
        out = {}
        for prefix, (name, pmap) in modules.items():
            for suffix, (leaf, tf) in pmap.items():
                node = tree["unet"].get(name, {})
                for k in leaf:
                    node = node.get(k, {}) if isinstance(node, dict) else {}
                if not isinstance(node, dict):
                    out[f"denoise_fn.{prefix}.{suffix}"] = inverse[tf](np.asarray(node))
        return out

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]

    def module(name):
        for pattern, form in ((r"(down|up)_(\d+)_(block|attn)_(\d+)", r"\1.\2.\3.\4"),
                              (r"(down|up)_(\d+)_(downsample|upsample)", r"\1.\2.\3"),
                              (r"mid_(block_1|attn_1|block_2)", r"mid.\1")):
            if re.fullmatch(pattern, name):
                return re.sub(pattern, form, name)
        return name

    model = unet(states["model"])
    for key, arr in flat(states["model"]["vqgan"]):
        parts = key.split(".")
        if parts[0] in ("encoder", "decoder"):
            parts[1] = module(parts[1])
        arr = np.asarray(arr)
        if parts[-1] == "embedding":
            parts.append("weight")
        elif parts[-1] in ("kernel", "scale"):
            arr = arr.transpose(3, 2, 0, 1) if parts[-1] == "kernel" else arr
            parts[-1] = "weight"
        model["vqgan." + ".".join(parts)] = arr
    tensors = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                         for k, v in d.items()}
    raw = {"model": tensors(model), "ema": tensors(unet(states["ema"])),
           "step": int(states["step"]), "epoch": int(states["epoch"])}
    for k in ("ori_latent_mean", "ori_latent_std", "cond_latent_mean", "cond_latent_std"):
        raw[k] = torch.from_numpy(np.asarray(states[k], np.float32).transpose(0, 3, 1, 2).copy())
    torch.save(raw, path)


@contextlib.contextmanager
def training_runs(store):
    """``(runner class, global_step, global_epoch, stop_reason)`` of each
    ``BaseRunner.train`` in the block, and every scalar the runners log as
    ``(tag, step, float32 value)``."""
    import numpy as np

    from bbdm_tpu_torch.runners.base import BaseRunner
    from bbdm_tpu_torch.utils.tboard import SummaryWriter

    train, add_scalar = BaseRunner.train, SummaryWriter.add_scalar
    store.update(runs=[], scalars=[])

    def traced_train(self):
        try:
            return train(self)
        finally:
            store["runs"].append((type(self).__name__, self.global_step, self.global_epoch,
                                  getattr(self, "stop_reason", None)))

    def traced_scalar(self, tag, value, step):
        store["scalars"].append((tag, int(step), float(np.float32(value))))
        return add_scalar(self, tag, value, step)

    BaseRunner.train, SummaryWriter.add_scalar = traced_train, traced_scalar
    try:
        yield store
    finally:
        BaseRunner.train, SummaryWriter.add_scalar = train, add_scalar


def demos_phase(dev, counters, root, configs=None, pairs=DEMO_PAIRS, size=256, stoch_size=64,
                wall=DEMO_WALL_S, draws=DEMO_DRAWS):
    """Phase 14 (see the module docstring): the chain, pixel and stochastic
    demonstrations, ``read_tboard`` and ``run_parity`` as a user runs them, each
    part's launches against :func:`kernel_calls`. ``configs`` (the four of
    :func:`demo_configs`), the tree sizes, ``wall`` and ``draws`` let a CPU
    rehearsal pass tiny models. Returns {part: results}."""
    import shutil

    import numpy as np

    from bbdm_tpu_torch.checkpoints.io import load_checkpoint
    from bbdm_tpu_torch.config import save_config
    from bbdm_tpu_torch.tools import (
        chain_demo,
        pixel_demo,
        random_lpips,
        read_tboard,
        run_parity,
        stochastic_demo,
    )
    from bbdm_tpu_torch.tools.sampler_sweep import nfe
    from bbdm_tpu_torch.tools.synthetic import write_stage

    configs = configs or demo_configs()
    cpu = [] if dev.type == "cuda" else ["--cpu"]
    work = os.path.join(root, "demos")
    n_train, n_val, n_test = pairs
    trees = {"restore": os.path.join(work, "synpix256"),
             "stochastic": os.path.join(work, "synstoch64")}
    for task, tree in trees.items():
        for stage, n, seed in (("train", n_train, 0), ("val", n_val, 1_000_000),
                               ("test", n_test, 2_000_000)):
            write_stage(tree, stage, n, size if task == "restore" else stoch_size, seed,
                        task=task)
    log(f"  demo trees: {pairs} pairs, restore at {size}^2, stochastic at {stoch_size}^2 "
        "(tools.synthetic)")
    paths = {}
    for name, cfg in configs.items():
        cfg.data.dataset_config.dataset_path = trees[
            "stochastic" if "stoch" in name else "restore"]
        paths[name] = os.path.join(work, f"{name}.yaml")
        save_config(cfg, paths[name])
    vq_cfg, lb_cfg, px_cfg, st_cfg = configs.values()
    log("reduced: " + json.dumps({
        "phase": 14, "pairs": {"run": list(pairs), "JAX round 4": [3000, 64, 64]},
        "chain": {"wall_a_s": wall, "wall_b_s": wall, "n_epochs": [vq_cfg.training.n_epochs,
                                                                    lb_cfg.training.n_epochs],
                  "phase_d_images": {"run": n_test, "default": 32}},
        "pixel": {"epochs": {"run": 1, "config": px_cfg.training.n_epochs},
                  "variants": {"run": DEMO_VARIANTS,
                               "default": "euler:100,euler:50,euler:20,heun:25,heun:10"}},
        "stochastic": {"epochs": {"run": 1, "config": st_cfg.training.n_epochs},
                       "variants": {"run": "%s:%d" % DEMO_STOCH_VARIANT,
                                    "default": "euler:200,...,heun:10"},
                       "sample_num": {"run": DEMO_STOCH_DRAWS, "default": 5}}}))
    out, launches = {}, {}

    def run(label, fn, argv, want, needed, caches=0):
        """``fn(argv)`` with the launches counted against ``want`` and the device
        caches its training builds (``caches``: how many the configs ask for,
        each logged)."""
        for mod, attr in counters.values():
            getattr(mod, attr).launches = 0
        store, builds, logged = {}, [], []
        with training_runs(store), cache_builds(builds), cache_logs(logged):
            result = fn(argv + cpu)
        got = {SHORT[k]: getattr(mod, attr).launches for k, (mod, attr) in counters.items()}
        want = want(store) if callable(want) else want
        launches[label] = got
        log(f"  {label}: launches {got}, derived from the code {want}; "
            f"training runs (class, steps, epoch, stop) {store['runs']}; device caches "
            f"{json.dumps(builds)}, logged {logged}")
        if got != want or not all(want[k] > 0 for k in needed):
            raise AssertionError(f"{label}: launches {got} != {want} (kernel_calls), or one of "
                                 f"{needed} never launched")
        if len(builds) != caches or len(logged) != caches:
            raise AssertionError(f"{label}: {len(builds)} device caches built and "
                                 f"{len(logged)} logged, the configs ask for {caches}")
        out[label] = {"launches": got, "result": result, "device_caches": builds}
        torch.cuda.empty_cache()
        return result, store

    add = lambda *ds: {k: sum(d[k] for d in ds) for k in ("K1", "K2", "K3")}

    # (a) the chain: VQGAN-f4 (fp32), then LBBDM-f4 on it, phase C, phase D
    chain = os.path.join(work, "chain")
    test_bs = lb_cfg.data.test.batch_size
    lb_calls = kernel_calls(lb_cfg.model, test_bs)
    vq_calls = kernel_calls(lb_cfg.model, vq_cfg.data.train.batch_size)
    steps = lb_cfg.model.BB.params.sample_step
    test_batches = n_test // test_bs
    train_batches = n_train // lb_cfg.data.train.batch_size

    def chain_launches(store):
        (_, vq_steps, vq_epoch, vq_stop), (_, micro, lb_epoch, lb_stop) = store["runs"]
        if not (vq_stop or "").startswith("wall budget") or \
                not (lb_stop or "").startswith("wall budget"):
            raise AssertionError(f"chain: training stopped by {vq_stop!r}, {lb_stop!r}")
        out["chain_steps"] = {"vqgan": vq_steps, "lbbdm_microbatches": micro}
        val_epochs = lambda cfg, epoch: epoch // cfg.training.validation_interval  # unstopped
        # a VQGAN step runs the encoder and the decoder in training mode (no K2:
        # the naive up-conv); its validation steps (every 50), validation epochs
        # (custom_single: A and B images) and sample grids (a train and a val
        # batch every sample_interval epochs) in eval mode
        vq_bs = vq_cfg.data.train.batch_size
        grid_every = max(int(vq_cfg.training.sample_interval * 2 * n_train // vq_bs), 1)
        vq_evals = (vq_steps // 50 + val_epochs(vq_cfg, vq_epoch) * (2 * n_val // vq_bs)
                    + 2 * (vq_steps // grid_every))
        vq = expected_launches(vq_calls, draws=1, batches=vq_steps)
        lb_evals = (micro // 50
                    + val_epochs(lb_cfg, lb_epoch) * (n_val // lb_cfg.data.val.batch_size))
        return add({"K1": vq["K1"], "K2": 0, "K3": vq["K3"]},
                   expected_launches(vq_calls, draws=1, batches=vq_evals),
                   expected_launches(lb_calls, batches=4 * train_batches,  # latent statistics
                                     microbatches=micro + lb_evals),
                   expected_launches(lb_calls, steps=steps, draws=1, batches=test_batches),
                   expected_launches(lb_calls, draws=1, batches=test_batches),  # the ceiling
                   expected_launches(lb_calls, steps=steps, draws=draws, batches=2))

    reports, store = run("demo_chain", chain_demo.main, [
        "--result", chain, "--vqgan-config", paths["VQGAN-f4-syn256-v2"],
        "--lbbdm-config", paths["LBBDM-f4-syn256-v2"], "--wall-a", str(wall),
        "--wall-b", str(wall), "--bench-sample-num", str(draws),
        "--bench-images", str(test_bs)], chain_launches, ("K1", "K2", "K3"),
        caches=2 * sum(bool(c.training.get("device_data_cache", False))
                       for c in (vq_cfg, lb_cfg)))  # train and val, each decoded once
    ev, tput = reports["eval"], reports["throughput"]
    for key in ("sample_vs_gt", "condition_vs_gt_floor", "vqgan_roundtrip_ceiling"):
        if ev[key]["count"] != n_test or not np.isfinite(ev[key]["psnr"]):
            raise AssertionError(f"chain phase C {key}: {ev[key]}")
    if (tput["samples"], tput["sample_num"]) != (test_bs * draws, draws):
        raise AssertionError(f"chain phase D: {tput}")
    check_png(os.path.join(ev["eval_root"], str(steps), "test_00000.png"), size, size)
    log(f"  chain: {out['chain_steps']}; PSNR/SSIM sample {ev['sample_vs_gt']['psnr']:.2f} / "
        f"{ev['sample_vs_gt']['ssim']:.3f}, floor {ev['condition_vs_gt_floor']['psnr']:.2f}, "
        f"ceiling {ev['vqgan_roundtrip_ceiling']['psnr']:.2f}; phase D {tput['samples']} "
        f"samples")

    # (d) read_tboard over (a)'s event files: the scalars the runners logged
    rows = read_tboard.main([chain] + cpu)
    got = sorted((tag, step, value) for tag, step, _, value in rows)
    if got != sorted(store["scalars"]) or not any(r[0] == "loss/train" for r in got):
        raise AssertionError(f"read_tboard: {len(got)} rows, the runners logged "
                             f"{len(store['scalars'])}: {got[:3]} vs {store['scalars'][:3]}")
    out["demo_read_tboard"] = {"rows": len(rows)}
    log(f"  demo_read_tboard: {len(rows)} rows equal to the logged scalars")

    # (e) run_parity over (a)'s checkpoints: the bridge as a reference .pth
    bridge = load_checkpoint(reports["bridge"]["ckpt"])
    pth = os.path.join(work, "bridge-reference.pth")
    reference_pth(bridge, lb_cfg.model, pth)
    lpips_w = random_lpips.main(["--out", os.path.join(work, "lpips_alex.pth")] + cpu)
    parity_out = os.path.join(work, "parity")
    scores, _ = run("demo_run_parity", run_parity.main, [
        "--vqgan", reports["vqgan"]["ckpt"], "--bbdm", pth, "--config",
        paths["LBBDM-f4-syn256-v2"], "--data", trees["restore"], "--out", parity_out,
        "--n", str(n_test), "--lpips-weights", lpips_w],
        expected_launches(lb_calls, steps=steps, draws=1, batches=test_batches), ("K1", "K2"))
    del bridge
    parity_tree = os.path.join(parity_out, "parity", lb_cfg.model.model_name, "sample_to_eval",
                               str(steps))
    a, b = read_pngs(parity_tree), read_pngs(os.path.join(ev["eval_root"], str(steps)))
    worst = max(int(np.abs(a[k].astype(int) - b[k]).max()) for k in b)
    out["demo_run_parity"].update(vs_phase_c_max_uint8=worst, scores=scores)
    log(f"  run_parity: LPIPS (random alex) {scores.get('LPIPS/port')}; its samples vs the "
        f"chain's phase C (the same weights, seed and images): max {worst} uint8 level(s)")
    if sorted(a) != sorted(b) or worst > 1 or "LPIPS/port" not in scores:
        raise AssertionError("run_parity: its samples differ from phase C's, or no LPIPS")
    shutil.rmtree(chain, ignore_errors=True)  # a few GB of checkpoints
    shutil.rmtree(parity_out, ignore_errors=True)

    # (b) the pixel demo: one epoch, phase E, phase S
    px_calls = kernel_calls(px_cfg.model, px_cfg.data.test.batch_size)
    px_test = n_test // px_cfg.data.test.batch_size
    sweep = [(s, int(n)) for s, n in (v.split(":") for v in DEMO_VARIANTS.split(","))]

    def pixel_launches(store):
        ((_, micro, _, _),) = store["runs"]
        val = n_val // px_cfg.data.val.batch_size  # the validation epoch's loss evaluations
        return add(expected_launches(px_calls, microbatches=micro + val),
                   *(expected_launches(px_calls, steps=nfe(s, n), draws=1, batches=px_test)
                     for s, n in [("euler", 200)] + sweep))

    rows, _ = run("demo_pixel", pixel_demo.main, [
        "--result", os.path.join(work, "pixel"), "--config", paths["BBDM-synpix64"],
        "--epochs", "1", "--variants", DEMO_VARIANTS], pixel_launches, ("K1", "K2"))
    if [(r["sampler"], r["steps"]) for r in rows] != [("euler", 200)] + sweep or any(
            r["sample_vs_gt"]["count"] != n_test or not np.isfinite(r["sample_vs_gt"]["psnr"])
            for r in rows):
        raise AssertionError(f"pixel demo rows: {rows}")
    for r in rows:
        log(f"  pixel {r['sampler']}:{r['steps']} PSNR/SSIM {r['sample_vs_gt']['psnr']:.2f} / "
            f"{r['sample_vs_gt']['ssim']:.3f} (floor {r['condition_vs_gt_floor']['psnr']:.2f})")

    # (c) the stochastic demo: phase T for one epoch (with the device cache its
    # config asks for), then phase S, one variant of DEMO_STOCH_DRAWS draws
    st_calls = kernel_calls(st_cfg.model, st_cfg.data.test.batch_size)
    sampler, n = DEMO_STOCH_VARIANT
    stoch = os.path.join(work, "stoch")

    def stochastic_launches(store):
        ((_, micro, _, _),) = store["runs"]
        val = n_val // st_cfg.data.val.batch_size  # the validation epoch's loss evaluations
        return add(expected_launches(st_calls, microbatches=micro + val),
                   expected_launches(st_calls, steps=nfe(sampler, n), draws=DEMO_STOCH_DRAWS,
                                     batches=n_test // st_cfg.data.test.batch_size))

    rows, _ = run("demo_stochastic", stochastic_demo.main, [
        "--result", stoch, "--config", paths["BBDM-synstoch64"], "--epochs", "1",
        "--variants", f"{sampler}:{n}", "--sample-num", str(DEMO_STOCH_DRAWS)],
        stochastic_launches, ("K1", "K2"),
        caches=2 * bool(st_cfg.training.get("device_data_cache", False)))
    (r,) = rows
    if (r["images"], sum(r["mode_histogram"])) != (n_test, n_test * DEMO_STOCH_DRAWS) or \
            not np.isfinite(r["best_mode_psnr_mean"]):
        raise AssertionError(f"stochastic demo: {r}")
    log(f"  stochastic {sampler}:{n} x {DEMO_STOCH_DRAWS}: best-mode PSNR "
        f"{r['best_mode_psnr_mean']}, margin {r['commit_margin_db_mean']} dB, coverage "
        f"{r['mode_coverage_mean']}, histogram {r['mode_histogram']}, diversity "
        f"{r['diversity']}, floor {r['condition_floor_best_mode_psnr']}")
    shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
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
    try:
        from bbdm_tpu_torch.native import build as host_build

        t0 = time.time()
        host_path = host_build.build()
        host_build.library()
        log(f"host image library build: {time.time() - t0:.1f} s ({os.path.basename(host_path)}, "
            f"{host_build.compiler()} {' '.join(host_build.FLAGS)})")
    except Exception:
        traceback.print_exc()
        log("host image library build: FAILED")
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

    agreement = {}
    try:
        t0 = time.time()
        launches, agreement = slice_phase(dev, counters)
        for e in entries:
            e["launches"] = launches[e["name"]]
        log(f"slice: ok ({time.time() - t0:.1f} s)")
    except Exception:
        traceback.print_exc()
        failed.append("slice")

    cli, train, vqgan, perceptual, evaluation, paths = {}, {}, {}, {}, {}, {}
    short = SHORT
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
                if e["name"] == "group_norm":
                    e["launches_by_path"]["train_backward"] = train["k1_backward_launches"]
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
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            perceptual = vqgan_perceptual_phase(dev, counters, root)
            for e in entries:
                e["launches_by_path"]["vqgan_train_perceptual"] = \
                    perceptual["launches"][short[e["name"]]]
            log(f"vqgan perceptual train: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("vqgan perceptual train")
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            evaluation = eval_phase(dev, root, cli["f4_euler_sample_to_eval"]["tree"])
            log(f"evaluation: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("evaluation")
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            paths = latent_paths_phase(dev, counters, root)
            for e in entries:
                for p, r in paths.items():
                    for run in ("sample_to_eval", "train"):
                        e["launches_by_path"][f"{p}_{run}"] = r[run]["launches"][short[e["name"]]]
                    if e["name"] == "group_norm":
                        e["launches_by_path"][f"{p}_train_backward"] = \
                            r["train"]["k1_backward_launches"]
            log(f"latent paths: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("latent paths")
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            dp = parallel_phase(dev, root)
            for e in entries:
                k = short[e["name"]]
                e["launches_by_path"].update({
                    "dp_train_per_rank": dp["train"]["launches"][k],
                    "dp_sample_to_eval_per_rank": dp["sample_to_eval"]["launches"][k],
                    "dp_vqgan_train_per_rank": dp["vqgan_train"]["launches"][k],
                    "nccl_train": dp["nccl"]["train_launches"][k],
                    "nccl_sample_to_eval": dp["nccl"]["sample_launches"][k]})
            log(f"data parallel: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("data parallel")
            dp = {}
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            sh = sharding_phase(dev, root)
            for e in entries:
                k = short[e["name"]]
                e["launches_by_path"].update({
                    "fsdp_train_per_rank": sh["train"]["fsdp"]["launches"][k],
                    "tp_train_per_rank": sh["train"]["tp"]["launches"][k],
                    "fsdp_vqgan_train_per_rank": sh["vqgan_train"]["fsdp"]["launches"][k],
                    "tp_vqgan_train_per_rank": sh["vqgan_train"]["tp"]["launches"][k],
                    "tp_sample_to_eval_per_rank": sh["sample_to_eval"]["launches"][k]})
            log(f"fsdp and tensor parallel: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("fsdp and tensor parallel")
            sh = {}
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            data = data_phase(dev, counters, root)
            for e in entries:
                k = short[e["name"]]
                e["launches_by_path"].update({
                    "data_inpainting_train": data["train"]["launches"][k],
                    "data_lab_sample_to_eval": data["lab_sample_to_eval"]["launches"][k],
                    "data_webp_sample_to_eval": data["webp_sample_to_eval"]["launches"][k]})
            log(f"data layer: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("data layer")
            data = {}
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            tools = tools_phase(dev, root, cli["f4_euler_sample_to_eval"]["tree"],
                                os.path.join(root, "LBBDM-f4-euler-1.yaml"),
                                os.path.join(root, "LBBDM-f4-vqgan.ckpt"))
            for e in entries:
                k = short[e["name"]]
                e["launches_by_path"].update({f"tools_{p}": n[k]
                                              for p, n in tools["launches"].items()})
            log(f"tools: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("tools")
            tools = {}
        torch.cuda.empty_cache()
        try:
            t0 = time.time()
            demos = demos_phase(dev, counters, root)
            for e in entries:
                k = short[e["name"]]
                e["launches_by_path"].update({p: n[k] for p, n in demos["launches"].items()})
            log(f"demos: ok ({time.time() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append("demos")
            demos = {}

    log(json.dumps({"kernels": entries, "slice": agreement, "cli": cli, "train": train,
                    "vqgan_train": vqgan, "vqgan_train_perceptual": perceptual,
                    "evaluation": evaluation, "latent_paths": paths, "parallel": dp,
                    "sharding": sh, "data": data, "tools": tools, "demos": demos,
                    "card": card}))
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
