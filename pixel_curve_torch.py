"""Train the port's pixel BBDM on the card and hold its loss curve against the
JAX run's archived one.

    python pixel_curve_torch.py [--tree datasets/synpix256] [--epochs 11] \\
        [--result results/run_pixel_curve] [--out chiprun_out/pixel_curve]

1. Writes the JAX round-4 tree with ``tools.synthetic`` (``--task restore``,
   3000 train, 64 val, 64 test pairs at 256^2) where ``--tree`` does not exist.
2. Runs ``tools.pixel_demo`` on ``configs/runs/BBDM-synpix64.yaml`` (whose
   ``dataset_path`` is ``datasets/synpix256``: run it from the checkout's root)
   with ``--epochs`` (11: 187 steps an epoch, 2,057 steps), then its phase E
   (200-step euler ``sample_to_eval`` with the EMA weights) and phase S.
3. Reads the run's event files with ``tools.read_tboard`` and prints, at steps
   500, 1000 and 2000, the mean ``loss/train`` of the 100 steps ending there and
   the mean ``loss/val_step`` of the points in (step - 250, step], beside the
   same windows of ``--jax-csv`` (the JAX run's scalars), with their ratio.

Prints the card (``nvidia-smi`` name and power limit), the seconds of each
part, steps per second (from the event wall times of steps 1 and 2000, as the
JAX figure is taken), peak device memory, phase E's PSNR/SSIM beside the
copy-the-input floor, and as its last line one JSON object with all of it,
also written to ``<out>/curve.json`` beside copies of the reports and the
event file. Needs the CUDA card.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import shutil
import subprocess
import time

WINDOWS = (500, 1000, 2000)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", default="datasets/synpix256")
    ap.add_argument("--config", default="configs/runs/BBDM-synpix64.yaml")
    ap.add_argument("--epochs", type=int, default=11)
    ap.add_argument("--result", default="results/run_pixel_curve")
    ap.add_argument("--jax-csv", default="artifacts/round4/pixel64/scalars.csv")
    ap.add_argument("--out", default="chiprun_out/pixel_curve")
    return ap.parse_args(argv)


def windows(rows):
    """{step: (train mean of (step-100, step], val_step mean of (step-250, step])}
    over (tag, step, value) rows; None where a window is empty."""
    def mean(tag, lo, hi):
        vals = [v for t, s, v in rows if t == tag and lo < s <= hi]
        return sum(vals) / len(vals) if vals else None

    return {s: (mean("loss/train", s - 100, s), mean("loss/val_step", s - 250, s))
            for s in WINDOWS}


def card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""


def main(argv=None) -> dict:
    import torch

    from bbdm_tpu_torch.config import load_config
    from bbdm_tpu_torch.models.factory import resolve_device
    from bbdm_tpu_torch.tools import pixel_demo, read_tboard, synthetic

    args = parse_args(argv)
    resolve_device("cuda")
    out = {"card": card(), "device": torch.cuda.get_device_name(0), "seconds": {}}
    print(out["card"], flush=True)
    secs = out["seconds"]
    if not os.path.isdir(args.tree):
        t0 = time.time()
        synthetic.main(["--out", args.tree, "--task", "restore", "--train", "3000",
                        "--val", "64", "--test", "64"])
        secs["dataset"] = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rows = pixel_demo.main(["--config", args.config, "--epochs", str(args.epochs),
                            "--result", args.result])
    secs["pixel_demo"] = time.time() - t0
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(args.result, "report_train.json")) as f:
        train = json.load(f)
    secs["train"] = train["wall_sec"]

    cfg = load_config(args.config)
    log_dir = os.path.join(args.result, cfg.data.dataset_name, cfg.model.model_name, "log")
    events = list(read_tboard.read_dir(log_dir))
    port = [(t, s, v) for t, s, _, v in events]
    with open(args.jax_csv) as f:
        jax = [(r["tag"], int(r["step"]), float(r["value"])) for r in csv.DictReader(f)]
    wall = {s: w for t, s, w, _ in events if t == "loss/train"}
    out["steps"] = max(wall)
    out["steps_per_s_1_to_2000"] = (2000 - 1) / (wall[2000] - wall[1]) if 2000 in wall else None
    out["windows"] = {}
    print("step | port train / val | JAX train / val | train ratio", flush=True)
    for s, (mine, theirs) in zip(WINDOWS, zip(windows(port).values(),
                                              windows(jax).values())):
        ratio = mine[0] / theirs[0] if mine[0] is not None else None
        out["windows"][s] = {"port": mine, "jax": theirs, "train_ratio": ratio}
        print(f"{s} | {mine[0]} / {mine[1]} | {theirs[0]} / {theirs[1]} | {ratio}", flush=True)
    e = rows[0]
    out["eval_euler200"] = {"sample_vs_gt": e["sample_vs_gt"],
                            "condition_vs_gt_floor": e["condition_vs_gt_floor"],
                            "wall_sec_incl_compile": e["wall_sec_incl_compile"]}
    out["sweep"] = [{k: r[k] for k in ("sampler", "steps", "nfe", "wall_sec_incl_compile")}
                    | {"psnr": r["sample_vs_gt"]["psnr"], "ssim": r["sample_vs_gt"]["ssim"]}
                    for r in rows[1:]]
    os.makedirs(args.out, exist_ok=True)
    for p in glob.glob(os.path.join(args.result, "report_*.json")) + \
            glob.glob(os.path.join(log_dir, "*tfevents*")):
        shutil.copy(p, args.out)
    with open(os.path.join(args.out, "curve.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
