"""Pixel-space BBDM quality demonstration (port of ``scripts/train_pixel_demo.py``):

* phase T trains the pixel BBDM of ``--config`` (``configs/runs/BBDM-synpix64.yaml``,
  the configuration that needs no pretrained first stage) with the port's
  ``BBDMRunner``, resuming from ``last_model.ckpt``/``last_optim_sche.ckpt``
  where an earlier invocation left them;
* phase E runs the 200-step euler ``sample_to_eval`` over the test split with
  the EMA weights, then PSNR/SSIM of the samples against the ground truth and
  of the condition against it (the copy-the-input floor);
* phase S runs each ``--variants`` ``sampler:steps`` on the same checkpoint:
  quality and wall time per variant.

Each phase writes ``<result>/report_<phase>.json`` (``train``,
``eval_euler200``, ``sweep_<sampler><steps>``, with the JAX script's keys) and
is skipped when its report exists, so a crashed or interrupted run continues.
A phase not started by ``--deadline-ts`` (a unix time) is skipped and the
command exits 0; rerunning it resumes.

    python -m bbdm_tpu_torch.tools.pixel_demo [--result results/run_r4_pixel] \\
        [--config configs/runs/BBDM-synpix64.yaml] [--epochs N] [--deadline-ts TS] \\
        [--variants euler:100,euler:50,euler:20,heun:25,heun:10] [--cpu]

Runs on the CUDA card and raises where there is none; ``--cpu`` runs on the
CPU. One deviation from the JAX script: a training phase cut short by a
SIGTERM or the stop file writes no report (the rule of the JAX chain and
stochastic demos), where the JAX script writes one and a rerun would then
sample a model that did not finish. Not ported: the TPU service wait
(``BBDM_BACKEND_WAIT``, ``bbdm_tpu/utils/backend.py`` is TPU-only) and the JAX
compilation cache.
"""

from __future__ import annotations

import argparse
import gc
import os
import time

from bbdm_tpu_torch.tools._demo import Reports, interrupted, make_args, past_deadline
from bbdm_tpu_torch.tools.sampler_sweep import nfe

TAG = "pixel"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--result", default="results/run_r4_pixel")
    ap.add_argument("--config", default="configs/runs/BBDM-synpix64.yaml")
    ap.add_argument("--epochs", type=int, default=None, help="cap training n_epochs (time-box)")
    ap.add_argument("--variants", default="euler:100,euler:50,euler:20,heun:25,heun:10",
                    help="phase-S sampler:steps list (euler:200 is phase E)")
    ap.add_argument("--deadline-ts", type=float, default=None,
                    help="unix timestamp: phases not yet STARTED by this time are skipped "
                         "and the command exits cleanly (reports make the next invocation "
                         "resume there)")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Returns the rows of phases E and S that have reports."""
    from bbdm_tpu_torch.config import apply_cli_overrides, load_config
    from bbdm_tpu_torch.evaluation import calc_psnr_ssim
    from bbdm_tpu_torch.models.factory import resolve_device
    from bbdm_tpu_torch.runners import get_runner

    args = parse_args(argv)
    resolve_device("cpu" if args.cpu else "cuda")  # no card: raise before any work
    reports = Reports(args.result, TAG)
    cfg0 = load_config(args.config)
    model_name = cfg0.model.model_name
    ckpt_dir = os.path.join(args.result, cfg0.data.dataset_name, model_name, "checkpoint")
    bridge_ckpt = os.path.join(ckpt_dir, "last_model.ckpt")
    optim_ckpt = os.path.join(ckpt_dir, "last_optim_sche.ckpt")

    # ---------------- phase T: train to plateau
    if reports.exists("train"):
        print(f"[{TAG}:train] report exists, skipping", flush=True)
    elif past_deadline(args.deadline_ts, TAG, "phase train"):
        return []
    else:
        cfg = load_config(args.config)
        resume = os.path.exists(bridge_ckpt) and os.path.exists(optim_ckpt)
        apply_cli_overrides(cfg, make_args(
            args.result, args.cpu, max_epoch=args.epochs,
            resume_model=bridge_ckpt if resume else None,
            resume_optim=optim_ckpt if resume else None))
        if resume:
            print(f"[{TAG}:train] resuming from {bridge_ckpt}", flush=True)
        t0 = time.perf_counter()
        runner = get_runner(cfg.runner, cfg)
        runner.train()
        wall = time.perf_counter() - t0
        if interrupted(runner, TAG, "T"):
            return []
        del runner
        gc.collect()
        reports.write("train", {"config": args.config, "ckpt": bridge_ckpt,
                                "wall_sec": round(wall, 1), "epochs_cap": args.epochs})

    # ---------------- phases E + S: sample_to_eval variants
    def run_variant(sampler, steps, phase):
        if reports.exists(phase):
            print(f"[{TAG}:{phase}] report exists, skipping", flush=True)
            return reports.read(phase)
        if past_deadline(args.deadline_ts, TAG, f"phase {phase}"):
            return None
        cfg = load_config(args.config)
        cfg.model.model_load_path = bridge_ckpt
        cfg.model.model_name = f"{model_name}-{sampler}{steps}"
        cfg.model.BB.params.sampler = sampler
        cfg.model.BB.params.sample_step = steps
        cfg.testing.sample_num = 1
        apply_cli_overrides(cfg, make_args(args.result, args.cpu, train=False,
                                           sample_to_eval=True))
        runner = get_runner(cfg.runner, cfg)
        t0 = time.perf_counter()
        runner.test()
        wall = time.perf_counter() - t0
        root = runner.config.result.sample_to_eval_path
        del runner
        gc.collect()
        res = calc_psnr_ssim(os.path.join(root, str(steps)), os.path.join(root, "ground_truth"))
        floor = calc_psnr_ssim(os.path.join(root, "condition"),
                               os.path.join(root, "ground_truth"))
        return reports.write(phase, {
            "sampler": sampler, "steps": steps, "nfe": nfe(sampler, steps),
            "wall_sec_incl_compile": round(wall, 1),
            "sample_vs_gt": res, "condition_vs_gt_floor": floor, "eval_root": root})

    rows = [run_variant("euler", 200, "eval_euler200")]
    for variant in args.variants.split(","):
        sampler, steps = variant.strip().split(":")
        rows.append(run_variant(sampler, int(steps), f"sweep_{sampler}{steps}"))

    rows = [r for r in rows if r is not None]
    print(f"[{TAG}] final table (PSNR/SSIM vs gt; floor = condition vs gt):")
    for r in rows:
        print(f"  {r['sampler']:5s} steps={r['steps']:4d} NFE={r['nfe']:4d} "
              f"PSNR={r['sample_vs_gt']['psnr']:.2f} "
              f"SSIM={r['sample_vs_gt']['ssim']:.3f} "
              f"floorPSNR={r['condition_vs_gt_floor']['psnr']:.2f} "
              f"floorSSIM={r['condition_vs_gt_floor']['ssim']:.3f} "
              f"wall={r['wall_sec_incl_compile']}s", flush=True)
    return rows


if __name__ == "__main__":
    main()
