"""Profile the LBBDM-f4 slice on one CUDA card: sampler step, encode, decode.

    python -m bbdm_tpu_torch.profile_slice

Full width (VQGAN ch 128 x (1,2,4) at 256^2, UNet mc 128 x (1,4,8) at 64^2),
bf16, batch 8, random weights from seed 0. For each region it prints the host
wall time (synchronised, median of ``REPS``), the device busy time (the sum of
the card's kernel, copy and fill times that ``torch.profiler`` records, per
rep), the idle share 1 - busy / wall, the hand-written kernels' share, K1's
bound (the bytes its GroupNorm calls must move, each input read once and each
output written once, over the H100's 3.35 TB/s) and the kernels that take the
most device time. The sampler region is one ``p_sample_loop`` of ``STEPS``
steps, reported per step.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from bbdm_tpu_torch.ops import PEAK_BYTES_S

# name fragments of the hand-written kernels
KERNELS = {"K1": ("group_norm_kernel",), "K2": ("subpixel_upconv_kernel",),
           "K3": ("flash_attention_kernel",)}
STEPS, REPS, TOP = 3, 3, 6  # sampler steps per loop, timed repeats, kernels listed


def k1_bytes(fn):
    """Bytes K1's calls in one fn() must move (:func:`group_norm_bytes` summed),
    counted on one eager pass: a sampler step replayed as a CUDA graph calls
    no Python."""
    from bbdm_tpu_torch.models import bridge
    from bbdm_tpu_torch.ops import group_norm

    op, graphed, total = group_norm.group_norm, bridge._graph_steps, [0]

    def counting(x, weight, bias, *, film_scale=None, **kw):
        total[0] += group_norm.group_norm_bytes(x, weight, film_scale)
        return op(x, weight, bias, film_scale=film_scale, **kw)

    group_norm.group_norm, bridge._graph_steps = counting, lambda y: False
    try:
        fn()
    finally:
        group_norm.group_norm, bridge._graph_steps = op, graphed
    return total[0]

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
        # a span's annotation on the card's timeline covers kernels counted already
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps / per
    wall = statistics.median(walls) / per
    busy = sum(dev.values())
    return wall, busy, dev


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA card")

    from bbdm_tpu_torch.config import lbbdm_f4_config
    from bbdm_tpu_torch.models import build_model

    cfg = lbbdm_f4_config()
    cfg.model.BB.params.sample_step = STEPS
    dev = torch.device("cuda", 0)
    model = build_model(cfg.model, device=dev)  # seeded random weights (seed 0)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"{smi.stdout.strip() or torch.cuda.get_device_name(0)}; batch {batch}, bf16, "
          f"{len(noise)}-step loop, "
          f"median of {REPS}", flush=True)
    for name, (fn, per) in regions.items():
        wall, busy, dev_ms = measure(fn, REPS, per)
        kern = {k: sum(v for n, v in dev_ms.items() if any(p in n for p in pats))
                for k, pats in KERNELS.items()}
        k1_bound = k1_bytes(fn) / per / PEAK_BYTES_S * 1e3
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:TOP]
        print(json.dumps({"region": name, "wall_ms": wall, "device_busy_ms": busy,
                          "idle_share": 1 - busy / wall, "kernels_ms": kern,
                          "k1_bound_ms": k1_bound,
                          "k1_share_of_bound": k1_bound / kern["K1"] if kern["K1"] else None}),
              flush=True)
        for n, v in top:
            print(f"    {v:8.3f} ms  {n[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
