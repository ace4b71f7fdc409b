"""Evaluation prep and metric CLI of the PyTorch port: the flags and ``-f`` modes
of ``preprocess_and_evaluation.py``.

    python preprocess_and_evaluation_torch.py -f rename_samples -r ROOT -s SRC -t DST
    python preprocess_and_evaluation_torch.py -f copy_samples   -r ROOT -s SRC -t DST
    python preprocess_and_evaluation_torch.py -f LPIPS          -s DATA -t GT -n 5
    python preprocess_and_evaluation_torch.py -f max_min_LPIPS  -s DATA -t GT -n 5
    python preprocess_and_evaluation_torch.py -f diversity      -s DATA -n 5
    python preprocess_and_evaluation_torch.py -f FID            -s DIR1 -t DIR2
    python preprocess_and_evaluation_torch.py -f psnr_ssim      -s DATA -t GT

``--weights`` (or ``BBDM_FID_WEIGHTS`` / ``BBDM_LPIPS_WEIGHTS``) names the
backbone's weights. The metric networks (LPIPS, max_min_LPIPS, FID) run on CUDA
card 0 and raise where there is none; ``--cpu`` runs them on the CPU. The other
modes are file operations and numpy.
"""

from __future__ import annotations

import argparse
import os
import shutil

NETWORK_MODES = ("LPIPS", "max_min_LPIPS", "FID")


def make_dir(d):
    os.makedirs(d, exist_ok=True)
    return d


def rename_sample_files(source_dir: str, target_dir: str):
    """Reindex a sample tree to 0..N-1 names (reference `:10-27`)."""
    flist = sorted(os.listdir(source_dir))
    make_dir(target_dir)
    for i, name in enumerate(flist):
        if i % 1000 == 0:
            print(f"{i} samples")
        fpath = os.path.join(source_dir, name)
        if os.path.isdir(fpath):
            shutil.copytree(fpath, os.path.join(target_dir, str(i)))
        else:
            shutil.copy(fpath, os.path.join(target_dir, f"{i}.png"))


def copy_sample_files(source_dir: str, target_dir: str):
    """Flatten per-image subdirs to <name>.png via output_0 (reference `:30-40`)."""
    flist = sorted(os.listdir(source_dir))
    make_dir(target_dir)
    for i, name in enumerate(flist):
        if i % 1000 == 0:
            print(f"{i} samples")
        shutil.copy(os.path.join(source_dir, name, "output_0.png"),
                    os.path.join(target_dir, f"{name}.png"))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-f", "--func_name", type=str, required=True)
    parser.add_argument("-r", "--root_dir", type=str, default=None)
    parser.add_argument("-s", "--source_dir", type=str, default=None)
    parser.add_argument("-t", "--target_dir", type=str, default=None)
    parser.add_argument("-n", "--num_samples", type=int, default=1)
    parser.add_argument("--weights", type=str, default=None,
                        help="metric backbone weights (FID/LPIPS)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the metric networks on the CPU (default: CUDA card 0)")
    return parser.parse_args(argv)


def main(argv=None):
    """Run one ``-f`` mode; returns its value (None for the file operations)."""
    args = parse_args(argv)
    device = None
    if args.func_name in NETWORK_MODES:
        from bbdm_tpu_torch.models.factory import resolve_device

        device = resolve_device("cpu" if args.cpu else "cuda:0")

    if args.func_name == "rename_samples":
        src = os.path.join(args.root_dir, args.source_dir)
        dst = os.path.join(args.root_dir, args.target_dir)
        print(f"rename sample files from {src} to {dst}")
        return rename_sample_files(src, dst)
    if args.func_name == "copy_samples":
        src = os.path.join(args.root_dir, args.source_dir)
        dst = os.path.join(args.root_dir, args.target_dir)
        print(f"copy sample files from {src} to {dst}")
        return copy_sample_files(src, dst)
    if args.func_name == "LPIPS":
        from bbdm_tpu_torch.evaluation.lpips import calc_LPIPS

        print(f"calculate LPIPS {args.source_dir}")
        return calc_LPIPS(args.source_dir, args.target_dir, args.num_samples,
                          weights_path=args.weights, device=device)
    if args.func_name == "max_min_LPIPS":
        from bbdm_tpu_torch.evaluation.lpips import find_max_min_LPIPS

        print(f"calculate max_min_LPIPS {args.source_dir}")
        return find_max_min_LPIPS(args.source_dir, args.target_dir, args.num_samples,
                                  weights_path=args.weights, device=device)
    if args.func_name == "diversity":
        from bbdm_tpu_torch.evaluation.diversity import calc_diversity

        print(f"calculate diversity {args.source_dir}")
        return calc_diversity(args.source_dir, args.num_samples)
    if args.func_name == "FID":
        from bbdm_tpu_torch.evaluation.fid import calc_FID

        return calc_FID(args.source_dir, args.target_dir, weights_path=args.weights,
                        device=device)
    if args.func_name == "psnr_ssim":
        from bbdm_tpu_torch.evaluation.pixel_metrics import calc_psnr_ssim

        return calc_psnr_ssim(args.source_dir, args.target_dir)
    raise NotImplementedError(args.func_name)
