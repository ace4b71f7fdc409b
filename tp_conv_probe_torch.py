"""Hold the VQGAN GAN step's column-parallel convolutions under
``training.model_parallel: 2`` against the whole convolution, layer by layer.

    python tp_conv_probe_torch.py [--config configs/Template-VQGAN-f4.yaml] \\
        [--batch 2] [--out chiprun_out/tp_conv_probe.json] [--cpu]

One fp32 GAN step (TF32 off, as the port runs it) of ``VQGANRunner`` on one
rank, the setting of ``chip_smoke.py`` phase 11 (c) (node batch 2, the
discriminator from step 0, no perceptual term). Every ``Conv2d`` and training
``UpsampleConv3x3`` that the model axis of 2 splits (output channels even)
records its input and, in the backward, the gradient of its output. For each
call the script then computes, on the same input:

* forward: the whole convolution ``conv(x, W)`` and rank 0's gathered output
  under tensor parallelism, ``cat(conv(x, W[:co/2]), conv(x, W[co/2:]))``
  (each rank computes its half on the same input: ``parallel/tensor.py``);
* backward: the whole ``convolution_backward`` (dx, dW) and the split one
  (dx the sum of the halves' dx, as ``_ToModel``'s all-reduce adds them; dW
  the halves' dW concatenated);
* each against the same convolution in float64, and the device kernels each
  side launched (``torch.profiler``): the algorithm cuDNN picked.

Prints the card, the first call (forward order, then backward order) whose
split result is more than 1e-6 of the whole one's largest magnitude away from
it, with its shapes and kernels, a table of every call, and as its last line a
JSON summary; writes every call's record to ``--out``. Needs the CUDA card
unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import torch
import torch.nn.functional as F

THRESHOLD = 1e-6  # of the whole output's (or gradient's) largest magnitude


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="configs/Template-VQGAN-f4.yaml")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default="chiprun_out/tp_conv_probe.json")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def rel(a, b):
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def kernels(dev, fn):
    """(fn's result, {device kernel name without its signature: launches})."""
    if dev.type != "cuda":
        return fn(), {}
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = Counter(e.name.split("(")[0].removeprefix("void ") for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, dict(sorted(names.items()))


def conv_bwd(dy, h, w, stride, padding, mask=(True, True, False)):
    return torch.ops.aten.convolution_backward(dy, h, w, None, [stride] * 2, [padding] * 2,
                                               [1, 1], False, [0, 0], 1, list(mask))[:2]


class Probe:
    """Forward hooks on the split layers: each call's input (after the
    training up-conv's upsample) and, from a hook on its output, the output's
    gradient."""

    def __init__(self, model):
        from bbdm_tpu_torch.models.layers import Conv2d, UpsampleConv3x3, upsample_nearest_2x

        self.calls = []
        for name, m in model.named_modules():
            if isinstance(m, (Conv2d, UpsampleConv3x3)) and m.out_ch % 2 == 0:
                up = isinstance(m, UpsampleConv3x3)
                m.register_forward_hook(self.hook(name, m, up, upsample_nearest_2x))

    def hook(self, name, m, up, upsample):
        def record(module, args, out):
            if not module.training or not torch.is_grad_enabled():
                return
            h = upsample(args[0]) if up else args[0]
            call = {"layer": name, "h": h.detach(), "w": m.weight.detach(),
                    "stride": 1 if up else m.stride, "padding": 1 if up else m.padding,
                    "dy": None}
            self.calls.append(call)
            if out.requires_grad:
                out.register_hook(lambda g: call.__setitem__("dy", g.detach()))
        return record


def compare(dev, call):
    h, w, s, p = call["h"], call["w"], call["stride"], call["padding"]
    half = w.shape[0] // 2
    conv = lambda x, k: F.conv2d(x, k, stride=s, padding=p)
    full, k_full = kernels(dev, lambda: conv(h, w))
    parts, k_split = kernels(dev, lambda: [conv(h, w[:half]), conv(h, w[half:])])
    split = torch.cat(parts, 1)
    ref = conv(h.double(), w.double())
    r = {"layer": call["layer"], "x": list(h.shape), "w": list(w.shape), "stride": s,
         "padding": p, "fwd": {"split_vs_whole": rel(split, full),
                               "whole_vs_f64": rel(full, ref), "split_vs_f64": rel(split, ref),
                               "kernels_whole": k_full, "kernels_split": k_split}}
    dy = call["dy"]
    if dy is not None:
        (dx, dw), kb_full = kernels(dev, lambda: conv_bwd(dy, h, w, s, p))
        halves, kb_split = kernels(dev, lambda: [conv_bwd(dy[:, :half].contiguous(), h,
                                                          w[:half], s, p),
                                                 conv_bwd(dy[:, half:].contiguous(), h,
                                                          w[half:], s, p)])
        dx_s = halves[0][0] + halves[1][0]
        dw_s = torch.cat([halves[0][1], halves[1][1]])
        dx64, dw64 = conv_bwd(dy.double(), h.double(), w.double(), s, p)
        r["bwd"] = {"dx_split_vs_whole": rel(dx_s, dx), "dw_split_vs_whole": rel(dw_s, dw),
                    "dx_whole_vs_f64": rel(dx, dx64), "dx_split_vs_f64": rel(dx_s, dx64),
                    "dw_whole_vs_f64": rel(dw, dw64), "dw_split_vs_f64": rel(dw_s, dw64),
                    "kernels_whole": kb_full, "kernels_split": kb_split}
    return r


def card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read (no nvidia-smi)"


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    import main_torch
    from bbdm_tpu_torch.config import apply_cli_overrides, load_config
    from bbdm_tpu_torch.runners.vqgan import VQGANRunner

    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tp_conv_probe_torch.py needs the CUDA card (or --cpu)")
    print(f"card: {card()}; torch {torch.__version__}; cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, cudnn.benchmark {torch.backends.cudnn.benchmark}",
          flush=True)
    result = tempfile.mkdtemp(prefix="tp-probe-")
    cli = main_torch.parse_args(["-c", args.config, "--train", "-r", result,
                                 "-s", str(args.seed)] + (["--gpu_ids", "-1"] if args.cpu
                                                          else []))
    cfg = apply_cli_overrides(load_config(args.config), cli)
    cfg.model.loss.disc_start, cfg.model.loss.perceptual_weight = 0, 0.0
    cfg.model.loss.lpips_weights = None
    runner = VQGANRunner(cfg, device=dev)
    size = cfg.data.dataset_config.image_size
    rs = np.random.RandomState(args.seed)
    x = torch.from_numpy(rs.uniform(-1, 1, (args.batch, 3, size, size)).astype(np.float32))
    x = x.to(dev)
    probe = Probe(runner.model)
    runner.model.train()
    step = runner.build_train_step()
    metrics = step(runner.state, x, x, runner.train_generator)
    print("GAN step: " + json.dumps({k: float(v) for k, v in metrics.items()}), flush=True)
    records = [compare(dev, c) for c in probe.calls]
    for i, r in enumerate(records):
        r["call"] = i
    first = next((r for r in records if r["fwd"]["split_vs_whole"] > THRESHOLD), None)
    backward = [r for r in reversed(records) if "bwd" in r]
    first_b = next((r for r in backward
                    if max(r["bwd"]["dx_split_vs_whole"], r["bwd"]["dw_split_vs_whole"])
                    > THRESHOLD), None)
    print(f"{'call':>4} {'layer':<44} {'x':<20} {'w':<18} {'fwd split/whole':>15} "
          f"{'whole/f64':>10} {'split/f64':>10} {'dx s/w':>9} {'dw s/w':>9} same fwd kernels")
    for r in records:
        b = r.get("bwd", {})
        same = set(r["fwd"]["kernels_whole"]) == set(r["fwd"]["kernels_split"])
        print(f"{r['call']:>4} {r['layer']:<44} {str(r['x']):<20} {str(r['w']):<18} "
              f"{r['fwd']['split_vs_whole']:15.3e} {r['fwd']['whole_vs_f64']:10.3e} "
              f"{r['fwd']['split_vs_f64']:10.3e} {b.get('dx_split_vs_whole', float('nan')):9.2e}"
              f" {b.get('dw_split_vs_whole', float('nan')):9.2e} {same}")
    for label, r in (("forward", first), ("backward", first_b)):
        if r is None:
            print(f"first {label} call beyond {THRESHOLD}: none")
            continue
        print(f"first {label} call beyond {THRESHOLD}: {r['layer']} (call {r['call']}), x "
              f"{r['x']}, w {r['w']}, stride {r['stride']}, padding {r['padding']}: "
              + json.dumps({k: v for k, v in r["fwd" if label == "forward" else "bwd"].items()}))
    summary = {
        "card": card(), "calls": len(records), "threshold": THRESHOLD,
        "first_forward": first and {k: first[k] for k in ("call", "layer", "x", "w")},
        "first_backward": first_b and {k: first_b[k] for k in ("call", "layer", "x", "w")},
        "beyond_forward": sum(r["fwd"]["split_vs_whole"] > THRESHOLD for r in records),
        "beyond_forward_other_kernels": sum(
            r["fwd"]["split_vs_whole"] > THRESHOLD
            and set(r["fwd"]["kernels_whole"]) != set(r["fwd"]["kernels_split"])
            for r in records),
        "forward_other_kernels": sum(set(r["fwd"]["kernels_whole"])
                                     != set(r["fwd"]["kernels_split"]) for r in records),
        "max": {"fwd_split_vs_whole": max(r["fwd"]["split_vs_whole"] for r in records),
                "fwd_whole_vs_f64": max(r["fwd"]["whole_vs_f64"] for r in records),
                "fwd_split_vs_f64": max(r["fwd"]["split_vs_f64"] for r in records),
                "dx_split_vs_whole": max(r["bwd"]["dx_split_vs_whole"] for r in backward),
                "dw_split_vs_whole": max(r["bwd"]["dw_split_vs_whole"] for r in backward),
                "dw_whole_vs_f64": max(r["bwd"]["dw_whole_vs_f64"] for r in backward),
                "dw_split_vs_f64": max(r["bwd"]["dw_split_vs_f64"] for r in backward)}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "calls": records}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
