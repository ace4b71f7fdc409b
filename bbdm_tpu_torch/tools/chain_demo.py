"""The full chain, first stage to samples, in one process (port of
``scripts/train_chain_demo.py``):

* phase A trains the VQGAN-f4 first stage (``VQGANRunner``) on the synthetic
  paired tree (``--vqgan-config``, ``configs/runs/VQGAN-f4-syn256-v2.yaml``);
* phase B trains LBBDM-f4 (``--lbbdm-config``,
  ``configs/runs/LBBDM-f4-syn256-v2.yaml``, ``model_name`` ``LBBDM-f4-chain``)
  with that checkpoint as its frozen first stage, the latent statistics pass
  included;
* phase C runs ``sample_to_eval`` over the test split with the EMA weights, then
  PSNR/SSIM of the samples against the ground truth, of the condition against
  it (the copy-the-input floor) and of the first stage's own roundtrip of the
  same ground truth (``LatentBrownianBridgeModel.sample_vqgan``: the ceiling);
* phase D measures the delivered throughput of ``sample_to_eval`` at
  ``--bench-sample-num`` draws (5, the reference protocol) over
  ``--bench-images`` test images: one untimed warm-up batch, then the timed
  sweep, PNG encoding and writing included (compare with ``bench_torch.py``'s
  bare sampler).

Each phase writes ``<result>/report_<phase>.json`` (``vqgan``, ``bridge``,
``eval``, ``throughput``, with the JAX script's keys) and is skipped when its
report exists; a training phase that died before its report resumes from its
``last_model``/``last_optim_sche``. A training phase cut short by a SIGTERM or
the stop file writes no report and the command exits 0; ``--wall-a``/``--wall-b``
(``training.max_wall_sec``) are time boxes and count as done. A phase not
started by ``--deadline-ts`` is skipped. ``--throughput-only`` runs phase D
alone (random weights unless ``--skip-vqgan`` names a first stage).

    python -m bbdm_tpu_torch.tools.chain_demo [--result results/run_r4_chain] \\
        [--vqgan-config configs/runs/VQGAN-f4-syn256-v2.yaml] \\
        [--lbbdm-config configs/runs/LBBDM-f4-syn256-v2.yaml] [--skip-vqgan CKPT] \\
        [--epochs-a N] [--epochs-b N] [--wall-a SEC] [--wall-b SEC] \\
        [--bench-sample-num 5] [--bench-images 32] [--bench-sampler S] \\
        [--bench-sample-step N] [--throughput-only] [--deadline-ts TS] [--cpu]

Runs on the CUDA card and raises where there is none; ``--cpu`` runs on the
CPU. Phase D takes its batches from the runner's ``_build_loaders()``, which
builds the train loader too (the JAX runner's ``for_training=False`` skips
it). Not ported: the TPU service wait (``BBDM_BACKEND_WAIT``,
``bbdm_tpu/utils/backend.py`` is TPU-only) and the JAX compilation cache.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

from bbdm_tpu_torch.tools._demo import (
    Reports,
    interrupted,
    make_args,
    past_deadline,
    resume_paths,
)

TAG = "chain"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--result", default="results/run_r4_chain")
    ap.add_argument("--vqgan-config", default="configs/runs/VQGAN-f4-syn256-v2.yaml")
    ap.add_argument("--lbbdm-config", default="configs/runs/LBBDM-f4-syn256-v2.yaml")
    ap.add_argument("--skip-vqgan", default=None,
                    help="existing first-stage ckpt; skips phase A")
    ap.add_argument("--epochs-a", type=int, default=None,
                    help="cap phase-A n_epochs (time-box long configs)")
    ap.add_argument("--epochs-b", type=int, default=None,
                    help="cap phase-B n_epochs (time-box long configs)")
    ap.add_argument("--wall-a", type=float, default=None,
                    help="wall-clock budget (sec) for phase-A training: the runner stops "
                         "gracefully at a step boundary, saves, and the chain goes on "
                         "(training.max_wall_sec)")
    ap.add_argument("--wall-b", type=float, default=None,
                    help="wall-clock budget (sec) for phase-B training")
    ap.add_argument("--bench-sample-num", type=int, default=5,
                    help="phase-D sample_num (canonical protocol: 5)")
    ap.add_argument("--bench-images", type=int, default=32,
                    help="phase-D test images to sweep (timed)")
    ap.add_argument("--bench-sampler", default=None,
                    help="phase-D sampler override (euler/heun; default: the config's)")
    ap.add_argument("--bench-sample-step", type=int, default=None,
                    help="phase-D sample_step override (default: the config's)")
    ap.add_argument("--throughput-only", action="store_true",
                    help="skip phases A-C and run only the phase-D throughput benchmark "
                         "(random weights unless --skip-vqgan provides a first stage)")
    ap.add_argument("--deadline-ts", type=float, default=None,
                    help="unix timestamp: phases not yet STARTED by this time are skipped "
                         "and the command exits cleanly (reports make the next invocation "
                         "resume there)")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def roundtrip_tree(runner, cfg, out_dir):
    """The first stage's reconstruction of every full test batch, one PNG per
    ground-truth name (the ceiling of phase C)."""
    import torch

    from bbdm_tpu_torch.data import DataLoader, get_dataset
    from bbdm_tpu_torch.utils.images import save_single_image

    os.makedirs(out_dir, exist_ok=True)
    _, _, test_ds = get_dataset(cfg.data)
    loader = DataLoader(test_ds, cfg.data.test.batch_size, shuffle=False, seed=1234)
    with torch.no_grad():
        for batch in loader:
            xrec = runner.model.sample_vqgan(runner._to_device(batch["x"]))
            xrec = xrec.float().permute(0, 2, 3, 1).cpu().numpy()
            for i, name in enumerate(batch["x_name"]):
                save_single_image(xrec[i], out_dir, f"{name}.png",
                                  to_normal=cfg.data.dataset_config.to_normal)


def main(argv=None) -> dict:
    """Returns {phase: report} of the phases that have reports."""
    from bbdm_tpu_torch.config import apply_cli_overrides, load_config
    from bbdm_tpu_torch.evaluation import calc_psnr_ssim
    from bbdm_tpu_torch.models.factory import resolve_device
    from bbdm_tpu_torch.runners import get_runner

    args = parse_args(argv)
    resolve_device("cpu" if args.cpu else "cuda")  # no card: raise before any work
    reports = Reports(args.result, TAG)
    final = ("vqgan", "bridge", "eval", "throughput")

    def done():
        out = {p: reports.read(p) for p in final if reports.exists(p)}
        for phase, report in out.items():
            print(f"[{TAG}] {phase}: " + json.dumps(report, default=float), flush=True)
        return out

    # ---------------- phase A: first-stage VQGAN training
    if args.throughput_only:
        vq_ckpt = args.skip_vqgan
        print("[chain] --throughput-only: phases A-C skipped "
              f"(first stage: {vq_ckpt or 'random init'})", flush=True)
    elif args.skip_vqgan:
        vq_ckpt = args.skip_vqgan
        print(f"[chain] phase A skipped, using {vq_ckpt}", flush=True)
    elif reports.exists("vqgan"):
        vq_ckpt = reports.read("vqgan")["ckpt"]
        print(f"[chain] phase A report exists, using {vq_ckpt}", flush=True)
    else:
        print("[chain] phase A: VQGAN-f4 first-stage training", flush=True)
        cfg_a = load_config(args.vqgan_config)
        apply_cli_overrides(cfg_a, make_args(
            args.result, args.cpu, max_epoch=args.epochs_a,
            **resume_paths(args.result, cfg_a.data.dataset_name, cfg_a.model.model_name, TAG)))
        if args.wall_a is not None:
            cfg_a.training.max_wall_sec = args.wall_a
        t0 = time.perf_counter()
        runner_a = get_runner(cfg_a.runner, cfg_a)
        runner_a.train()
        if interrupted(runner_a, TAG, "A"):
            return done()
        vq_ckpt = os.path.join(runner_a.config.result.ckpt_path, "last_model.ckpt")
        del runner_a
        gc.collect()
        reports.write("vqgan", {"config": args.vqgan_config, "ckpt": vq_ckpt,
                                "wall_sec": round(time.perf_counter() - t0, 1),
                                "epochs_cap": args.epochs_a})

    def lbbdm_cfg():
        cfg = load_config(args.lbbdm_config)
        cfg.model.VQGAN.params.ckpt_path = vq_ckpt
        cfg.model.model_name = "LBBDM-f4-chain"
        return cfg

    bridge_ckpt = None

    # ---------------- phase B: LBBDM with the trained first stage
    if reports.exists("bridge"):
        bridge_ckpt = reports.read("bridge")["ckpt"]
        print(f"[chain] phase B report exists, using {bridge_ckpt}", flush=True)
    elif args.throughput_only:
        pass
    elif past_deadline(args.deadline_ts, TAG, "phase B"):
        return done()
    else:
        print("[chain] phase B: LBBDM-f4 bridge training on the trained first stage",
              flush=True)
        cfg_b = lbbdm_cfg()
        apply_cli_overrides(cfg_b, make_args(
            args.result, args.cpu, max_epoch=args.epochs_b,
            **resume_paths(args.result, cfg_b.data.dataset_name, cfg_b.model.model_name, TAG)))
        if args.wall_b is not None:
            cfg_b.training.max_wall_sec = args.wall_b
        t0 = time.perf_counter()
        runner_b = get_runner(cfg_b.runner, cfg_b)
        runner_b.train()
        if interrupted(runner_b, TAG, "B"):
            return done()
        bridge_ckpt = os.path.join(runner_b.config.result.ckpt_path, "last_model.ckpt")
        del runner_b
        gc.collect()
        reports.write("bridge", {"config": args.lbbdm_config, "ckpt": bridge_ckpt,
                                 "vq_ckpt": vq_ckpt,
                                 "wall_sec": round(time.perf_counter() - t0, 1),
                                 "epochs_cap": args.epochs_b})

    # ---------------- phase C: sample_to_eval and weights-free metrics
    if reports.exists("eval"):
        print("[chain] phase C report exists, skipping", flush=True)
    elif args.throughput_only:
        pass
    elif past_deadline(args.deadline_ts, TAG, "phase C"):
        return done()
    else:
        print("[chain] phase C: sample_to_eval sweep + PSNR/SSIM", flush=True)
        cfg_c = lbbdm_cfg()
        cfg_c.model.model_load_path = bridge_ckpt
        cfg_c.testing.sample_num = 1
        apply_cli_overrides(cfg_c, make_args(args.result, args.cpu, train=False,
                                             sample_to_eval=True))
        runner_c = get_runner(cfg_c.runner, cfg_c)
        runner_c.test()
        eval_root = runner_c.config.result.sample_to_eval_path
        sample_dir = os.path.join(eval_root, str(cfg_c.model.BB.params.sample_step))
        gt_dir = os.path.join(eval_root, "ground_truth")
        recon_dir = os.path.join(eval_root, "vqgan_roundtrip")
        roundtrip_tree(runner_c, cfg_c, recon_dir)
        del runner_c
        gc.collect()
        reports.write("eval", {
            "sample_vs_gt": calc_psnr_ssim(sample_dir, gt_dir),
            "condition_vs_gt_floor": calc_psnr_ssim(os.path.join(eval_root, "condition"),
                                                    gt_dir),
            "vqgan_roundtrip_ceiling": calc_psnr_ssim(recon_dir, gt_dir),
            "eval_root": eval_root, "vq_ckpt": vq_ckpt, "bridge_ckpt": bridge_ckpt})

    # ---------------- phase D: delivered sample_to_eval throughput
    if reports.exists("throughput"):
        print("[chain] phase D report exists, skipping", flush=True)
    elif past_deadline(args.deadline_ts, TAG, "phase D"):
        return done()
    else:
        print(f"[chain] phase D: delivered sweep throughput at sample_num="
              f"{args.bench_sample_num}", flush=True)
        cfg_d = lbbdm_cfg()
        cfg_d.model.model_load_path = bridge_ckpt
        cfg_d.model.model_name = "LBBDM-f4-chain-tput"
        if bridge_ckpt is None:
            # random weights: no latent statistics exist (two scalar affines per
            # stream, neutral for the wall time)
            cfg_d.model.normalize_latent = False
        cfg_d.testing.sample_num = args.bench_sample_num
        if args.bench_sampler is not None:
            cfg_d.model.BB.params.sampler = args.bench_sampler
        if args.bench_sample_step is not None:
            cfg_d.model.BB.params.sample_step = args.bench_sample_step
        apply_cli_overrides(cfg_d, make_args(args.result, args.cpu, train=False,
                                             sample_to_eval=True))
        runner_d = get_runner(cfg_d.runner, cfg_d)
        _, val_loader, test_loader = runner_d._build_loaders()
        if len(test_loader) == 0:
            test_loader = val_loader
        batch_size = cfg_d.data.test.batch_size
        n_batches = max(args.bench_images // batch_size, 1)
        batches = []
        for b in test_loader:
            batches.append(b)
            if len(batches) >= n_batches:
                break
        out_root = runner_d.config.result.sample_to_eval_path
        # an untimed warm-up batch first (the first convolutions' algorithm
        # choice, the allocator), so the timed window is the steady state
        t0 = time.perf_counter()
        runner_d.sample_to_eval(iter(batches[:1]), out_root)
        compile_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner_d.sample_to_eval(iter(batches), out_root)
        wall = time.perf_counter() - t0
        del runner_d
        gc.collect()
        images = n_batches * batch_size
        samples = images * args.bench_sample_num
        reports.write("throughput", {
            "sample_num": args.bench_sample_num,
            "sampler": cfg_d.model.BB.params.get("sampler", "euler"),
            "sample_step": int(cfg_d.model.BB.params.sample_step),
            "images": images,
            "samples": samples,
            "wall_sec": round(wall, 2),
            "first_batch_wall_sec_incl_compile": round(compile_wall, 2),
            "delivered_samples_per_sec": round(samples / wall, 3),
            "delivered_images_per_sec": round(images / wall, 3),
            "note": "includes VQGAN encode/decode + host PNG encode/IO; "
                    "compare vs bench_torch.py bare-sampler samples/sec",
        })
    return done()


if __name__ == "__main__":
    main()
