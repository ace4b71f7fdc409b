"""Training-step throughput on one card (port of ``scripts/bench_train.py:24-114``;
the sampling bench is ``tools/bench.py``).

    python -m bbdm_tpu_torch.tools.bench_train               # CUDA card 0
    BENCH_DEVICE=cpu BENCH_CONFIG=configs/runs/LBBDM-smoke-cpu.yaml BENCH_BATCH=1 \\
        python -m bbdm_tpu_torch.tools.bench_train           # the CPU, for tests

Times the port's full LBBDM train step (``training/step.py``), with no
fallback: two frozen VQGAN encodes of the image and the condition, the bridge
loss on the latent, the backward through ``GroupNormFunction`` and
``FlashAttentionFunction``, and on every ``accumulate_grad_batches``-th
microbatch the optimizer, the plateau schedule and the EMA, with the config's
``accumulate_grad_batches`` (``BENCH_ACCUM`` overrides it) and identity latent
statistics. Inputs are zero images of the dataset's size; the weights are
seeded (``torch.Generator``, seed 0). One warm-up step, then 10 timed steps
(microbatches) ending in the host sync of the last loss.

Knobs as ``tools/bench.py``: ``BENCH_BATCH`` (8), ``BENCH_CONFIG``,
``BENCH_ACCUM``, ``BENCH_DEVICE``. ``BENCH_FUSE`` is not ported: the
small-leaf optimizer bucketing it A/Bs (``bbdm_tpu/training/bucket.py``) is a
TPU launch optimization the port does not have.

Prints ONE JSON line with ``scripts/bench_train.py``'s keys (``unit``
images/sec/card; ``vs_baseline`` against the same A100 TF32 ESTIMATE as the
sampling bench, over ``training_flops_per_image``) plus ``mfu``,
``peak_memory_bytes``, the accumulation, the kernels' launches over the 11
steps and the last loss in ``detail``.
"""

from __future__ import annotations

import json
import os
import time

import torch

from bbdm_tpu_torch.tools.bench import (
    REF_EST_FLOPS,
    bench_config,
    bench_device,
    build_kernels,
    device_detail,
    kernel_launches,
)


def make_state(model, config, device):
    """The runner's train state over the model's trainable parameters: the
    optimizer, the plateau at the configured lr, the EMA under ``EMA.use_ema``."""
    from bbdm_tpu_torch.training.ema import ema_init
    from bbdm_tpu_torch.training.optim import Optimizer
    from bbdm_tpu_torch.training.plateau import plateau_init
    from bbdm_tpu_torch.training.state import TrainState

    params = model.trainable_parameters()
    optim_cfg = config.model.BB.optimizer
    use_ema = "EMA" in config.model and config.model.EMA.get("use_ema", False)
    return TrainState(step=0, params=params, ema=ema_init(params) if use_ema else None,
                      optimizer=Optimizer(optim_cfg, params),
                      plateau=plateau_init(optim_cfg.lr, device))


def main() -> dict:
    from bbdm_tpu_torch.models import build_model
    from bbdm_tpu_torch.training.step import make_train_step
    from bbdm_tpu_torch.utils.flops import training_flops_per_image

    device = bench_device()
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    config = bench_config()
    if "BENCH_ACCUM" in os.environ:
        config.training.accumulate_grad_batches = int(os.environ["BENCH_ACCUM"])
    accumulate = int(config.training.get("accumulate_grad_batches", 1))
    build_s = build_kernels(device)
    model = build_model(config.model, device=device,
                        generator=torch.Generator(device).manual_seed(0)).train()
    state = make_state(model, config, device)
    train_step = make_train_step(model, config.training,
                                 config.model.EMA if "EMA" in config.model else None,
                                 config.model.BB.lr_scheduler)
    size = config.data.dataset_config.image_size
    ch = config.data.dataset_config.get("channels", 3)
    x = torch.zeros((batch, ch, size, size), device=device)
    y = torch.zeros((batch, ch, size, size), device=device)
    g = torch.Generator(device).manual_seed(1)

    kernel_launches(reset=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    float(train_step(state, x, y, g)["loss"])
    warmup_s = time.perf_counter() - t0
    print(f"warm-up step: {warmup_s:.3f} s", flush=True)

    runs = 10
    t0 = time.perf_counter()
    for _ in range(runs):
        metrics = train_step(state, x, y, g)
    loss = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / runs

    flops_per_image = training_flops_per_image(config.model)
    imgs_per_sec = batch / dt
    ref_est = REF_EST_FLOPS / flops_per_image
    achieved = imgs_per_sec * flops_per_image
    line = {
        "metric": f"{config.model.model_name} {size}x{size} train step",
        "value": round(imgs_per_sec, 3),
        "unit": "images/sec/card",
        "vs_baseline": round(imgs_per_sec / ref_est, 3),
        "detail": {
            **device_detail(device, achieved),
            "step_ms": dt * 1e3,
            "batch": batch,
            "accumulate_grad_batches": accumulate,
            "flops_per_image": flops_per_image,
            "achieved_tflops": achieved / 1e12,
            "ref_est_images_per_sec_a100_tf32": round(ref_est, 3),
            "warmup_s": warmup_s,
            "kernel_build_s": build_s,
            "launches": kernel_launches(),
            "loss": loss,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
