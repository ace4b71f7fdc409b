"""Stochastic-posterior demonstration (port of ``scripts/eval_stochastic_demo.py``):

* phase T trains the pixel BBDM of ``--config`` (``configs/runs/BBDM-synstoch64.yaml``)
  on a ``tools.synthetic --task stochastic`` tree, whose condition pins the
  scene and whose target is a uniformly random one of four global colour
  modes, each mode's rendering of val and test written under ``B_modes/``;
* phase S, for each ``--variants`` ``sampler:steps``, a ``--sample-num``-draw
  ``sample_to_eval`` over the test split, scored by :func:`score_mode_tree`
  (best-mode PSNR: each draw against its nearest mode; the commit margin, best
  minus second-best mode in dB; mode coverage, the distinct modes hit per
  condition; the histogram of draws per mode; the condition's best-mode PSNR as
  the floor) and by the reference's diversity protocol (``calc_diversity``) on
  the same tree.

Each phase writes ``<result>/report_<phase>.json`` (``train``,
``sweep_<sampler><steps>``, with the JAX script's keys) and is skipped when its
report exists. A training phase cut short by a SIGTERM or the stop file
writes no report, so the next invocation resumes it from ``last_model.ckpt``;
``--wall-t`` (``training.max_wall_sec``) is a time box and counts as done. A
phase or variant not started by ``--deadline-ts`` is skipped.

    python -m bbdm_tpu_torch.tools.stochastic_demo [--result results/run_r5_stoch] \\
        [--config configs/runs/BBDM-synstoch64.yaml] [--epochs N] [--wall-t SEC] \\
        [--variants euler:200,euler:50,euler:20,euler:10,heun:25,heun:10] \\
        [--sample-num 5] [--deadline-ts TS] [--cpu]

Runs on the CUDA card and raises where there is none; ``--cpu`` runs on the
CPU. Images are read with the port's ``read_image``, not Pillow. Not ported:
the TPU service wait (``BBDM_BACKEND_WAIT``, ``bbdm_tpu/utils/backend.py`` is
TPU-only) and the JAX compilation cache.
"""

from __future__ import annotations

import argparse
import gc
import os
import time

import numpy as np

from bbdm_tpu_torch.tools._demo import (
    Reports,
    interrupted,
    make_args,
    past_deadline,
    resume_paths,
)
from bbdm_tpu_torch.tools.sampler_sweep import nfe

TAG = "stoch"


def _load(path):
    from bbdm_tpu_torch.utils.images import read_image

    return read_image(path).astype(np.float64)


def _psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(255.0 ** 2 / mse)


def score_mode_tree(result_dir, modes_dir, cond_dir, sample_num, n_modes=4):
    """Best-mode PSNR, commit margin, coverage and histogram over a
    ``sample_num > 1`` ``sample_to_eval`` tree (``<result_dir>/<name>/output_<j>.png``)."""
    names = sorted(os.listdir(result_dir))
    best_psnrs, margins, coverages = [], [], []
    floor_psnrs = []
    hist = [0] * n_modes
    for name in names:
        gts = [_load(os.path.join(modes_dir, f"{name}_m{k}.png")) for k in range(n_modes)]
        cond = _load(os.path.join(cond_dir, f"{name}.png"))
        floor_psnrs.append(max(_psnr(cond, g) for g in gts))
        assigned = set()
        for j in range(sample_num):
            img = _load(os.path.join(result_dir, name, f"output_{j}.png"))
            ps = sorted(((_psnr(img, g), k) for k, g in enumerate(gts)), reverse=True)
            best_psnrs.append(ps[0][0])
            margins.append(ps[0][0] - ps[1][0])
            hist[ps[0][1]] += 1
            assigned.add(ps[0][1])
        coverages.append(len(assigned))
    return {
        "images": len(names),
        "draws_per_image": sample_num,
        "best_mode_psnr_mean": round(float(np.mean(best_psnrs)), 2),
        "best_mode_psnr_min": round(float(np.min(best_psnrs)), 2),
        "commit_margin_db_mean": round(float(np.mean(margins)), 2),
        "mode_coverage_mean": round(float(np.mean(coverages)), 3),
        "mode_histogram": hist,
        "condition_floor_best_mode_psnr": round(float(np.mean(floor_psnrs)), 2),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--result", default="results/run_r5_stoch")
    ap.add_argument("--config", default="configs/runs/BBDM-synstoch64.yaml")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--wall-t", type=float, default=None,
                    help="wall budget (sec) for phase-T training (training.max_wall_sec; "
                         "counts as completion)")
    ap.add_argument("--variants", default="euler:200,euler:50,euler:20,euler:10,heun:25,heun:10")
    ap.add_argument("--sample-num", type=int, default=5)
    ap.add_argument("--deadline-ts", type=float, default=None,
                    help="unix ts: phases/variants not yet started by this time are skipped; "
                         "re-run the same command to resume")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Returns the rows of the variants that have reports."""
    from bbdm_tpu_torch.config import apply_cli_overrides, load_config
    from bbdm_tpu_torch.evaluation import calc_diversity
    from bbdm_tpu_torch.models.factory import resolve_device
    from bbdm_tpu_torch.runners import get_runner

    args = parse_args(argv)
    resolve_device("cpu" if args.cpu else "cuda")  # no card: raise before any work
    reports = Reports(args.result, TAG)

    # ---------------- phase T: training
    if reports.exists("train"):
        ckpt = reports.read("train")["ckpt"]
        print(f"[{TAG}] phase T report exists, using {ckpt}", flush=True)
    else:
        if past_deadline(args.deadline_ts, TAG, "phase T"):
            return []
        cfg = load_config(args.config)
        resume = resume_paths(args.result, cfg.data.dataset_name, cfg.model.model_name, TAG)
        apply_cli_overrides(cfg, make_args(args.result, args.cpu, max_epoch=args.epochs,
                                           **resume))
        if args.wall_t is not None:
            cfg.training.max_wall_sec = args.wall_t
        t0 = time.perf_counter()
        runner = get_runner(cfg.runner, cfg)
        runner.train()
        if interrupted(runner, TAG, "T"):
            return []
        ckpt = os.path.join(runner.config.result.ckpt_path, "last_model.ckpt")
        del runner
        gc.collect()
        reports.write("train", {"config": args.config, "ckpt": ckpt,
                                "wall_sec": round(time.perf_counter() - t0, 1),
                                "epochs_cap": args.epochs})

    # ---------------- phase S: per-variant multi-draw sweeps and scoring
    data_root = load_config(args.config).data.dataset_config.dataset_path
    modes_dir = os.path.join(data_root, "test", "B_modes")
    rows = []
    for variant in args.variants.split(","):
        sampler, steps = variant.strip().split(":")
        steps = int(steps)
        phase = f"sweep_{sampler}{steps}"
        if reports.exists(phase):
            rows.append(reports.read(phase))
            print(f"[{TAG}] {phase} report exists, skipping", flush=True)
            continue
        if past_deadline(args.deadline_ts, TAG, phase):
            break
        cfg = load_config(args.config)
        cfg.model.model_load_path = ckpt
        cfg.model.model_name = f"stoch-{sampler}{steps}"
        cfg.model.BB.params.sampler = sampler
        cfg.model.BB.params.sample_step = steps
        cfg.testing.sample_num = args.sample_num
        cfg.args = make_args(args.result, args.cpu, train=False, sample_to_eval=True)
        runner = get_runner(cfg.runner, cfg)
        t0 = time.perf_counter()
        runner.test()
        wall = time.perf_counter() - t0
        eval_root = runner.config.result.sample_to_eval_path
        del runner
        gc.collect()

        result_dir = os.path.join(eval_root, str(steps))
        scores = score_mode_tree(result_dir, modes_dir, os.path.join(eval_root, "condition"),
                                 args.sample_num)
        diversity = calc_diversity(result_dir, num_samples=args.sample_num, use_names=True)
        rows.append(reports.write(phase, {
            "sampler": sampler, "steps": steps, "nfe": nfe(sampler, steps),
            "wall_sec_incl_compile": round(wall, 1),
            "diversity": round(float(diversity), 3), **scores}))

    # ---------------- final table
    if rows:
        print(f"[{TAG}] table (best-mode PSNR | commit margin | coverage | diversity):",
              flush=True)
        for r in rows:
            print(f"  {r['sampler']:5s} steps={r['steps']:4d} NFE={r['nfe']:4d}"
                  f" PSNR*={r['best_mode_psnr_mean']:.2f}"
                  f" margin={r['commit_margin_db_mean']:.2f}dB"
                  f" coverage={r['mode_coverage_mean']:.2f}"
                  f" diversity={r['diversity']:.3f}"
                  f" floor={r['condition_floor_best_mode_psnr']:.2f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
