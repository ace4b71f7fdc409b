"""Profile the LBBDM-f4 slice on one CUDA card: sampler step, encode, decode.

    python -m bbdm_tpu_torch.profile_slice

Full width (VQGAN ch 128 x (1,2,4) at 256^2, UNet mc 128 x (1,4,8) at 64^2),
bf16, batch 8, random weights from seed 0. For each region it prints the host
wall time (synchronised, median of ``REPS``), the device busy time (the sum of
the card's kernel, copy and fill times that ``torch.profiler`` records, per
rep), the idle share 1 - busy / wall, the hand-written kernels' share, and the
kernels that take the most device time. The sampler region is one
``p_sample_loop`` of ``STEPS`` steps, reported per step.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# name fragments of the hand-written kernels (K1 is Triton's _stats + _apply)
KERNELS = {"K1": ("_stats", "_apply"), "K2": ("subpixel_upconv_kernel",),
           "K3": ("flash_attention_kernel",)}
STEPS, REPS, TOP = 3, 3, 6  # sampler steps per loop, timed repeats, kernels listed


def measure(fn, reps, per):
    """Wall ms, device busy ms and the top kernels of fn(), each per ``per`` units."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps / per
    wall = statistics.median(walls) / per
    busy = sum(dev.values())
    return wall, busy, dev


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA card")

    from bbdm_tpu_torch.config import lbbdm_f4_config
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    cfg = lbbdm_f4_config()
    cfg.model.BB.params.sample_step = STEPS
    dev = torch.device("cuda", 0)
    model = BBDMRunner(cfg, device=dev, seed=0).model
    size, batch = cfg.data.dataset_config.image_size, 8
    rs = np.random.RandomState(0)
    x_cond = torch.from_numpy(rs.uniform(-1, 1, (batch, 3, size, size)).astype(np.float32)).to(dev)
    y = model.encode(x_cond)
    g = torch.Generator(dev).manual_seed(1)
    noise = [torch.randn(y.shape, generator=g, device=dev) for _ in model.coeffs.steps]
    z = model.p_sample_loop(y, noise=noise, clip_denoised=False)

    regions = {
        "sampler_step": (lambda: model.p_sample_loop(y, noise=noise, clip_denoised=False),
                         len(noise)),
        "encode": (lambda: model.encode(x_cond), 1),
        "decode": (lambda: model.decode(z), 1),
    }
    print(f"{torch.cuda.get_device_name(0)}; batch {batch}, bf16, {len(noise)}-step loop, "
          f"median of {REPS}", flush=True)
    for name, (fn, per) in regions.items():
        wall, busy, dev_ms = measure(fn, REPS, per)
        kern = {k: sum(v for n, v in dev_ms.items() if any(p in n for p in pats))
                for k, pats in KERNELS.items()}
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:TOP]
        print(json.dumps({"region": name, "wall_ms": wall, "device_busy_ms": busy,
                          "idle_share": 1 - busy / wall,
                          "kernels_ms": kern}), flush=True)
        for n, v in top:
            print(f"    {v:8.3f} ms  {n[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
