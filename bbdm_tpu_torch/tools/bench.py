"""Benchmark: LBBDM-f4 256^2 sampling throughput at 200 steps on one card
(port of ``bench.py:33-123``).

    python bench_torch.py                                    # CUDA card 0
    BENCH_STEPS=20 BENCH_SAMPLER=heun python bench_torch.py
    BENCH_DEVICE=cpu BENCH_CONFIG=configs/runs/LBBDM-smoke-cpu.yaml \\
        BENCH_STEPS=2 BENCH_BATCH=1 python bench_torch.py    # the CPU, for tests

Knobs: ``BENCH_BATCH`` (8), ``BENCH_CONFIG`` (``configs/Template-LBBDM-f4.yaml``),
``BENCH_STEPS`` (overrides ``sample_step``), ``BENCH_SAMPLER`` (``euler`` or
``heun``) and ``BENCH_DEVICE``: the CUDA card by default, raising where there
is none; ``cpu`` is the only way to run on the CPU.

The model is built from the config with weights seeded from a
``torch.Generator`` (seed 0; no ``ckpt_path`` is read) and samples a zero
``x_cond`` of [B, C, S, S] with ``clip_denoised=False``, S and C the
dataset's ``image_size`` and ``channels``: [B, 3, 256, 256] for the template,
the shape ``bench.py`` fixes for every config, and for any config the size
the FLOP count (``utils/flops.py``) assumes. One warm-up call
builds the kernels' library at first use (``kernels/build.py``; the build's
seconds are printed on an earlier line and are not timed); then 3 calls are
timed, each ending in the host sync of ``out.mean().item()``.

Prints ONE JSON line with ``bench.py``'s keys: ``metric``, ``value``,
``unit`` (samples/sec/card), ``vs_baseline`` and ``detail``. ``vs_baseline``
keeps the JAX bench's formula: the samples/s over an ESTIMATE of the
reference PyTorch repo on an A100 in TF32, 0.35 * 156e12 FLOP/s /
flops_per_sample, not a measurement. ``detail`` adds to ``bench.py``'s keys
``mfu`` (achieved FLOP/s over the H100's dense bf16 peak, ``ops.PEAK_BF16_FLOPS``),
``peak_memory_bytes`` (``torch.cuda.max_memory_allocated``), the seconds of
each timed call and the warm-up, the kernels' launches over the four calls
and the last output's mean; on the CPU ``mfu`` and ``peak_memory_bytes`` are
null.

Not ported, TPU-only: the persistent compilation cache (``bench.py:38-41``;
nothing here compiles per shape, and the kernels' library is cached by
``kernels/build.py``), ``BENCH_BACKEND_WAIT`` (``:45-49``, a wait for the TPU
service) and ``BBDM_XLA_OPTS`` (``:83-87``, XLA compiler options).
"""

from __future__ import annotations

import json
import os
import time

import torch

# the JAX bench's estimate of the reference on an A100: 35% of its TF32 peak
REF_EST_FLOPS = 0.35 * 156e12


def bench_device() -> torch.device:
    """``BENCH_DEVICE`` (default the CUDA card; raises where there is none)."""
    from bbdm_tpu_torch.models.factory import resolve_device

    device = torch.device(os.environ.get("BENCH_DEVICE", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: BENCH_DEVICE=cpu runs the bench on the CPU")
    return resolve_device(device)


def bench_config(default: str = "configs/Template-LBBDM-f4.yaml"):
    from bbdm_tpu_torch.config import load_config

    return load_config(os.environ.get("BENCH_CONFIG", default))


def build_kernels(device: torch.device):
    """Build (or load the cached) kernels' library before anything is timed;
    its seconds, printed, or None on the CPU, which launches no kernel."""
    if device.type != "cuda":
        return None
    from bbdm_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    build.library()
    seconds = time.perf_counter() - t0
    print(f"kernel build: {seconds:.3f} s", flush=True)
    return seconds


def kernel_launches(reset: bool = False) -> dict:
    """{K1, K2, K3: launches} of this process's kernel wrappers (each counts the
    launches of its kernel), after setting them to 0 when ``reset``."""
    from bbdm_tpu_torch.ops import attention, group_norm, upsample_conv

    fns = {"K1": group_norm.group_norm_cuda, "K2": upsample_conv.upsample_conv_cuda,
           "K3": attention.flash_attention_cuda}
    if reset:
        for f in fns.values():
            f.launches = 0
    return {k: f.launches for k, f in fns.items()}


def device_detail(device: torch.device, achieved_flops: float) -> dict:
    """The card's name, ``mfu`` and peak memory; on the CPU the name ``cpu``
    and no device numbers."""
    from bbdm_tpu_torch.ops import PEAK_BF16_FLOPS

    if device.type != "cuda":
        return {"device_kind": "cpu", "mfu": None, "peak_memory_bytes": None}
    return {"device_kind": torch.cuda.get_device_name(device),
            "mfu": achieved_flops / PEAK_BF16_FLOPS,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device)}


def main() -> dict:
    from bbdm_tpu_torch.models import build_model
    from bbdm_tpu_torch.utils.flops import sampling_flops_per_image

    device = bench_device()
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    config = bench_config()
    bb = config.model.BB.params
    if "BENCH_STEPS" in os.environ:
        bb.sample_step = int(os.environ["BENCH_STEPS"])
    if "BENCH_SAMPLER" in os.environ:
        bb.sampler = os.environ["BENCH_SAMPLER"]
    build_s = build_kernels(device)
    model = build_model(config.model, device=device,
                        generator=torch.Generator(device).manual_seed(0))
    flops_per_sample = sampling_flops_per_image(config.model)
    size = config.data.dataset_config.image_size
    ch = config.data.dataset_config.get("channels", 3)
    x_cond = torch.zeros((batch, ch, size, size), device=device)
    g = torch.Generator(device).manual_seed(1)

    def sample_mean() -> float:
        return model.sample(x_cond, clip_denoised=False, generator=g).mean().item()

    kernel_launches(reset=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    sample_mean()
    warmup_s = time.perf_counter() - t0
    print(f"warm-up call: {warmup_s:.3f} s", flush=True)

    runs, run_s = 3, []
    t0 = time.perf_counter()
    for _ in range(runs):
        t1 = time.perf_counter()
        mean = sample_mean()
        run_s.append(time.perf_counter() - t1)
    dt = (time.perf_counter() - t0) / runs

    samples_per_sec = batch / dt
    ref_est = REF_EST_FLOPS / flops_per_sample
    achieved = samples_per_sec * flops_per_sample
    sampler = bb.get("sampler", "euler")
    tag = "" if sampler == "euler" else f" ({sampler})"
    line = {
        "metric": f"{config.model.model_name} {size}x{size} "
                  f"{bb.sample_step}-step sampling{tag}",
        "value": round(samples_per_sec, 4),
        "unit": "samples/sec/card",
        "vs_baseline": round(samples_per_sec / ref_est, 3),
        "detail": {
            **device_detail(device, achieved),
            "flops_per_sample": flops_per_sample,
            "achieved_tflops": achieved / 1e12,
            "ref_est_samples_per_sec_a100_tf32": round(ref_est, 3),
            "batch": batch,
            "sampler": sampler,
            "sample_step": bb.sample_step,
            "run_s": run_s,
            "warmup_s": warmup_s,
            "kernel_build_s": build_s,
            "launches": kernel_launches(),
            "output_mean": mean,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
