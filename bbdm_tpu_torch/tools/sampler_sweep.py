"""Sampler-quality sweep: euler against heun at several step budgets on a
trained LBBDM checkpoint, through the full ``sample_to_eval`` path, scoring
PSNR/SSIM against the ground truth per variant (port of
``scripts/eval_sampler_sweep.py``).

    python -m bbdm_tpu_torch.tools.sampler_sweep \\
        [--lbbdm-config configs/runs/LBBDM-f4-syn256.yaml] \\
        [--vq-ckpt VQ.ckpt] [--bridge-ckpt LBBDM.ckpt] \\
        [--variants euler:200,euler:20,heun:20,heun:50] [--result results/run_r3_sweep] [--cpu]

For each ``sampler:steps`` variant: the config with the two checkpoints,
``model_name`` ``sweep-<sampler><steps>``, that sampler and ``sample_step``,
``testing.sample_num`` 1, then the port's ``BBDMRunner.test()`` (seed 1234,
the CUDA card, or the CPU with ``--cpu``), then ``calc_psnr_ssim`` of
``sample_to_eval/<steps>`` against ``sample_to_eval/ground_truth``. Each
variant writes ``<result>/report_<sampler><steps>.json`` (``nfe``: steps for
euler, 2(steps - 1) + 1 for heun; ``wall_sec_incl_compile``: the seconds of
``test()``, the kernels' first-use build included), and a variant whose
report exists is skipped, so an interrupted sweep resumes. Then the table is
printed.

Not ported: the TPU service wait (``BBDM_BACKEND_WAIT``) and the JAX
compilation cache.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lbbdm-config", default="configs/runs/LBBDM-f4-syn256.yaml")
    ap.add_argument("--vq-ckpt",
                    default="results/run_r3_chain/syn256/VQGAN-f4/checkpoint/last_model.ckpt")
    ap.add_argument("--bridge-ckpt",
                    default="results/run_r3_chain/syn256/LBBDM-f4-chain/checkpoint/"
                            "last_model.ckpt")
    ap.add_argument("--result", default="results/run_r3_sweep")
    ap.add_argument("--variants", default="euler:200,euler:20,heun:20,heun:50")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def make_args(result_path, gpu_ids):
    """The CLI namespace of ``main_torch.py --sample_to_eval`` for the runner."""
    return argparse.Namespace(
        train=False, sample_to_eval=True, sample_at_start=False, save_top=False,
        resume_model=None, resume_optim=None, max_epoch=None, max_steps=None,
        gpu_ids=gpu_ids, port="12355", config="", seed=1234, result_path=str(result_path))


def nfe(sampler: str, steps: int) -> int:
    return 2 * (steps - 1) + 1 if sampler == "heun" else steps


def variant_config(args, sampler: str, steps: int):
    from bbdm_tpu_torch.config import load_config

    cfg = load_config(args.lbbdm_config)
    cfg.model.VQGAN.params.ckpt_path = args.vq_ckpt
    cfg.model.model_load_path = args.bridge_ckpt
    cfg.model.model_name = f"sweep-{sampler}{steps}"
    cfg.model.BB.params.sampler = sampler
    cfg.model.BB.params.sample_step = steps
    cfg.testing.sample_num = 1
    return cfg


def main(argv=None) -> list:
    from bbdm_tpu_torch.evaluation import calc_psnr_ssim
    from bbdm_tpu_torch.models.factory import resolve_device
    from bbdm_tpu_torch.runners import get_runner

    args = parse_args(argv)
    resolve_device("cpu" if args.cpu else "cuda")  # no card: raise before any work
    rows = []
    for variant in args.variants.split(","):
        sampler, steps = variant.strip().split(":")
        steps = int(steps)
        rp = os.path.join(args.result, f"report_{sampler}{steps}.json")
        if os.path.exists(rp):
            with open(rp) as f:
                rows.append(json.load(f))
            print(f"[sweep] {sampler}:{steps} report exists, skipping", flush=True)
            continue
        cfg = variant_config(args, sampler, steps)
        cfg.args = make_args(args.result, "-1" if args.cpu else "0")
        runner = get_runner(cfg.runner, cfg)
        t0 = time.perf_counter()
        runner.test()
        wall = time.perf_counter() - t0
        root = runner.config.result.sample_to_eval_path
        res = calc_psnr_ssim(os.path.join(root, str(steps)), os.path.join(root, "ground_truth"))
        row = {"sampler": sampler, "steps": steps, "nfe": nfe(sampler, steps),
               "wall_sec_incl_compile": round(wall, 1), **res}
        os.makedirs(args.result, exist_ok=True)
        with open(rp, "w") as f:
            json.dump(row, f, indent=1, default=float)
        rows.append(row)
        print("[sweep] " + json.dumps(row, default=float), flush=True)
        del runner
    print("[sweep] table:")
    for r in rows:
        print(f"  {r['sampler']:5s} steps={r['steps']:4d} NFE={r['nfe']:4d} "
              f"PSNR={r['psnr']:.2f} SSIM={r['ssim']:.3f} "
              f"wall={r['wall_sec_incl_compile']}s", flush=True)
    return rows


if __name__ == "__main__":
    main()
