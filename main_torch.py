"""bbdm_tpu_torch CLI: the flags of ``main.py`` on the PyTorch port.

    python main_torch.py -c configs/Template-LBBDM-f4.yaml --train \\
        [--resume_model last_model.ckpt --resume_optim last_optim_sche.ckpt] [--max_epoch N]
    python main_torch.py -c configs/Template-LBBDM-f4.yaml --sample_to_eval \\
        --resume_model path/to/last_model.ckpt [-r results] [-s 1234]
    python main_torch.py -c configs/Template-VQGAN-f4.yaml --train   # the first stage

Runs on the CUDA card (``--gpu_ids N`` picks card N, default 0) and raises
where there is none; ``--gpu_ids -1`` runs on the CPU. It reads the YAML
subset of ``configs/*.yaml`` without PyYAML, model checkpoints written by the
JAX package (``.ckpt``) or the reference repo (``.pth``), and ``custom_single``
/ ``custom_aligned`` datasets of 8-bit PNG images, and writes the result tree
of ``main.py``: ``<result_path>/<dataset_name>/<model_name>/{image,log,
checkpoint,samples,sample_to_eval}``. ``--train`` trains (checkpoints in the
JAX package's layout, ``checkpoint/{latest,last}_{model,optim_sche}*.ckpt``);
without it, ``--sample_to_eval`` samples the test set (a VQGAN config:
reconstructs it) and otherwise the grids of the first test batch are written.
Several ``--gpu_ids`` raise. ``--port`` is accepted and unused.
"""

from __future__ import annotations

import argparse

from bbdm_tpu_torch.config import apply_cli_overrides, load_config
from bbdm_tpu_torch.runners import get_runner


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--config", type=str, default="BB_base.yml",
                        help="Path to the config file")
    parser.add_argument("-s", "--seed", type=int, default=1234, help="Random seed")
    parser.add_argument("-r", "--result_path", type=str, default="results",
                        help="The directory to save results")

    parser.add_argument("-t", "--train", action="store_true", default=False,
                        help="train the model")
    parser.add_argument("--sample_to_eval", action="store_true", default=False,
                        help="sample for evaluation")
    parser.add_argument("--sample_at_start", action="store_true", default=False,
                        help="sample at start(for debug)")
    parser.add_argument("--save_top", action="store_true", default=False,
                        help="save top loss checkpoint")

    parser.add_argument("--gpu_ids", type=str, default="0",
                        help="-1 runs on the CPU; N runs on CUDA card N")
    parser.add_argument("--port", type=str, default="12355", help="compat flag (unused)")

    parser.add_argument("--resume_model", type=str, default=None, help="model checkpoint")
    parser.add_argument("--resume_optim", type=str, default=None, help="optimizer checkpoint")

    parser.add_argument("--max_epoch", type=int, default=None, help="cap training.n_epochs")
    parser.add_argument("--max_steps", type=int, default=None, help="cap training.n_steps")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = apply_cli_overrides(load_config(args.config), args)
    runner = get_runner(config.runner, config)
    if args.train:
        runner.train()
    else:
        runner.test()
    return runner


if __name__ == "__main__":
    main()
