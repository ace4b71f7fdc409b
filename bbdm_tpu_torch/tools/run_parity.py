"""One command that pushes real weights through the whole port (port of
``scripts/run_parity.py``):

    python -m bbdm_tpu_torch.tools.run_parity \\
        --vqgan  /path/to/ldm_vqgan.ckpt      # LDM torch ckpt, or a JAX-layout first stage \\
        --bbdm   /path/to/released_bbdm.pth   # reference training checkpoint \\
        --config configs/Template-LBBDM-f4.yaml \\
        --data   /path/to/paired_dataset      # custom_aligned layout ({test}/A,B) \\
        --out    $TMPDIR/bbdm_parity \\
        [--fid-weights inception.pth] [--lpips-weights lpips_alex.pth] \\
        [--n 8] [--sample-num 1] [--cpu]

It converts the reference ``.pth`` with ``checkpoints/torch_import.py`` into
the JAX package's layout (``<out>/converted_model.ckpt``), loads it (the
first stage through the runner's own loader), runs ``sample_to_eval`` over
``--n`` test images (the reference's directory contract), then FID and LPIPS
of the samples against the ground truth with the port's metrics
(``evaluation/fid.py``, ``evaluation/lpips.py``), and the same through the
``pytorch_fid`` and ``lpips`` pip packages where they import, printing the
deltas; where they do not, it says that they were skipped. Without ``--data``
it writes ``--n`` ``tools.synthetic`` test pairs (and two train and two val
pairs) under ``<out>/synthetic_data``. Each missing piece skips its stage
with a notice: without ``--bbdm`` the UNet has random weights; without metric
weights (``--fid-weights``/``BBDM_FID_WEIGHTS``,
``--lpips-weights``/``BBDM_LPIPS_WEIGHTS``) only the sampling path runs.

Runs on the CUDA card and raises where there is none; ``--cpu`` runs on the
CPU. Not ported: the JAX mesh key (``training.mesh_device_ids``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--vqgan", required=True, help="LDM VQGAN torch checkpoint")
    ap.add_argument("--bbdm", default=None,
                    help="released BBDM/LBBDM torch training checkpoint (optional: without "
                         "it, sampling runs from random UNet weights)")
    ap.add_argument("--config", default="configs/Template-LBBDM-f4.yaml")
    ap.add_argument("--data", default=None,
                    help="custom_aligned dataset root; default synthesizes N pairs with "
                         "tools.synthetic")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "bbdm_parity"))
    ap.add_argument("--n", type=int, default=8, help="test images to sample")
    ap.add_argument("--sample-num", type=int, default=1)
    ap.add_argument("--fid-weights", default=os.environ.get("BBDM_FID_WEIGHTS"))
    ap.add_argument("--lpips-weights", default=os.environ.get("BBDM_LPIPS_WEIGHTS"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--seed", type=int, default=1234)
    return ap.parse_args(argv)


def package_lpips(sample_dir, gt_dir):
    """Mean LPIPS alex of the pip ``lpips`` package over the names in both
    directories, on the CPU (the reference's ``evaluation/LPIPS.py``); raises
    ImportError where the package is absent."""
    import lpips as lpips_pkg
    import numpy as np
    import torch

    from bbdm_tpu_torch.utils.images import read_image

    loss_fn = lpips_pkg.LPIPS(net="alex")

    def load(p):
        x = read_image(p).astype(np.float32) / 127.5 - 1
        return torch.from_numpy(x.transpose(2, 0, 1))[None]

    total, n = 0.0, 0
    for f in sorted(os.listdir(gt_dir)):
        a, b = os.path.join(sample_dir, f), os.path.join(gt_dir, f)
        if not (os.path.exists(a) and os.path.exists(b)):
            continue
        with torch.no_grad():
            total += float(loss_fn(load(a), load(b)))
        n += 1
    return total / n if n else None


def main(argv=None) -> dict:
    """Returns {metric: value} of the metrics computed."""
    from bbdm_tpu_torch.config import load_config
    from bbdm_tpu_torch.models.factory import resolve_device
    from bbdm_tpu_torch.runners import get_runner

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")  # no card: raise before any work
    os.makedirs(args.out, exist_ok=True)
    config = load_config(args.config)
    image_size = config.data.dataset_config.image_size

    # ---- dataset
    data_root = args.data
    if data_root is None:
        data_root = os.path.join(args.out, "synthetic_data")
        if not os.path.exists(data_root):
            from bbdm_tpu_torch.tools.synthetic import write_stage

            print(f"[data] synthesizing {args.n} paired test images -> {data_root}")
            write_stage(data_root, "test", args.n, image_size, args.seed)
            # train/val dirs must exist for get_dataset; tiny stubs
            write_stage(data_root, "train", 2, image_size, args.seed + 10_000)
            write_stage(data_root, "val", 2, image_size, args.seed + 20_000)

    # ---- checkpoint conversion
    if not os.path.exists(args.vqgan):
        sys.exit(f"[convert] VQGAN checkpoint not found: {args.vqgan}")
    config.model.VQGAN.params.ckpt_path = args.vqgan

    if args.bbdm:
        from bbdm_tpu_torch.checkpoints.io import save_checkpoint
        from bbdm_tpu_torch.checkpoints.torch_import import convert_reference_checkpoint

        print(f"[convert] reference checkpoint {args.bbdm}")
        ckpt = convert_reference_checkpoint(args.bbdm, config.model)
        converted = os.path.join(args.out, "converted_model.ckpt")
        save_checkpoint(ckpt, converted)
        config.model.model_load_path = converted
        print(f"[convert] -> {converted} (step={ckpt['step']}, epoch={ckpt['epoch']})")

    # ---- sample_to_eval sweep
    config.data.dataset_name = "parity"
    config.data.dataset_config.dataset_path = data_root
    config.data.test.batch_size = min(config.data.test.batch_size, args.n)
    config.testing.sample_num = args.sample_num
    config.args = argparse.Namespace(
        config=args.config, seed=args.seed, result_path=args.out,
        train=False, sample_to_eval=True, sample_at_start=False,
        save_top=False, gpu_ids="-1" if args.cpu else "0", port="12355",
        resume_model=None, resume_optim=None, max_epoch=None, max_steps=None)

    runner = get_runner(config.runner, config)
    runner.test()
    eval_root = runner.config.result.sample_to_eval_path
    sample_dir = os.path.join(eval_root, str(config.model.BB.params.sample_step))
    gt_dir = os.path.join(eval_root, "ground_truth")
    del runner
    print(f"[sample] wrote {eval_root}")

    if args.sample_num > 1:
        # sample_num > 1 writes <step>/<name>/output_<j>.png; the flat-directory
        # protocols take one flat directory of the first draws (the whole tree
        # stays in sample_dir for diversity / max_min_LPIPS by hand)
        flat = os.path.join(args.out, "samples_flat")
        os.makedirs(flat, exist_ok=True)
        for name in sorted(os.listdir(sample_dir)):
            src = os.path.join(sample_dir, name, "output_0.png")
            dst = os.path.join(flat, f"{name}.png")
            if os.path.exists(src) and not os.path.exists(dst):
                os.symlink(os.path.abspath(src), dst)
        print(f"[metrics] sample_num={args.sample_num}: metrics use first draws flattened "
              f"into {flat}")
        sample_dir = flat

    # ---- metrics: the port's, and the pip packages' where they import
    results = {}
    if args.fid_weights and os.path.exists(args.fid_weights):
        from bbdm_tpu_torch.evaluation import calc_FID

        results["FID/port"] = calc_FID(sample_dir, gt_dir, weights_path=args.fid_weights,
                                       device=device)
    else:
        print("[metrics] FID(port) skipped: no --fid-weights")
    if args.lpips_weights and os.path.exists(args.lpips_weights):
        from bbdm_tpu_torch.evaluation.lpips import paired_LPIPS

        results["LPIPS/port"] = paired_LPIPS(sample_dir, gt_dir,
                                             weights_path=args.lpips_weights, device=device)
    else:
        print("[metrics] LPIPS(port) skipped: no --lpips-weights")

    try:
        from pytorch_fid.fid_score import calculate_fid_given_paths

        results["FID/torch"] = calculate_fid_given_paths(
            [sample_dir, gt_dir], batch_size=8, device="cpu", dims=2048)
    except ImportError:
        print("[metrics] FID(torch) skipped: pytorch_fid not installed")
    try:
        value = package_lpips(sample_dir, gt_dir)
        if value is not None:
            results["LPIPS/torch"] = value
    except ImportError:
        print("[metrics] LPIPS(torch) skipped: lpips not installed")

    # ---- report
    print("\n=== parity report ===")
    for k, v in results.items():
        print(f"{k}: {v:.6f}")
    for m in ("FID", "LPIPS"):
        j, t = results.get(f"{m}/port"), results.get(f"{m}/torch")
        if j is not None and t is not None:
            print(f"{m} delta (port - torch): {j - t:+.6f} "
                  f"({abs(j - t) / max(abs(t), 1e-9):.3%} relative)")
    if not results:
        print("no metric weights/packages available - sampling-path parity only "
              "(directory contract written)")
    return results


if __name__ == "__main__":
    main()
