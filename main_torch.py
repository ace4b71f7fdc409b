"""bbdm_tpu_torch CLI: the flags of ``main.py`` on the PyTorch port.

    python main_torch.py -c configs/Template-LBBDM-f4.yaml --train \\
        [--resume_model last_model.ckpt --resume_optim last_optim_sche.ckpt] [--max_epoch N]
    python main_torch.py -c configs/Template-LBBDM-f4.yaml --sample_to_eval \\
        --resume_model path/to/last_model.ckpt [-r results] [-s 1234]
    python main_torch.py -c configs/Template-VQGAN-f4.yaml --train   # the first stage
    python main_torch.py -c configs/Template-LBBDM-f4.yaml --train --gpu_ids 0,1,2,3

Runs on the CUDA card (``--gpu_ids N`` picks card N, default 0) and raises
where there is none; ``--gpu_ids -1`` runs on the CPU. Several ids start one
process (rank) per card with ``torch.multiprocessing``, rank i on the i-th
id, joined over NCCL at ``127.0.0.1:--port``: data-parallel training and
sampling, in which ``data.*.batch_size`` is the batch of all of them together,
split evenly (``bbdm_tpu_torch/parallel``). ``BBDM_MULTIHOST=1`` with
``BBDM_COORDINATOR``, ``BBDM_NUM_PROCESSES`` and ``BBDM_PROCESS_ID`` makes the
invocation one node of several, each with its ``--gpu_ids`` ranks (with
``--gpu_ids -1``, one CPU rank over gloo), and the batch size per node.

It reads the YAML subset of ``configs/*.yaml`` without PyYAML, model
checkpoints written by the JAX package (``.ckpt``) or the reference repo
(``.pth``), and ``custom_single`` / ``custom_aligned`` datasets of 8-bit PNG
images, and writes the result tree of ``main.py``:
``<result_path>/<dataset_name>/<model_name>/{image,log,checkpoint,samples,
sample_to_eval}``. ``--train`` trains (checkpoints in the JAX package's
layout, ``checkpoint/{latest,last}_{model,optim_sche}*.ckpt``); without it,
``--sample_to_eval`` samples the test set (a VQGAN config: reconstructs it)
and otherwise the grids of the first test batch are written.
"""

from __future__ import annotations

import argparse
import os
import sys

from bbdm_tpu_torch import parallel
from bbdm_tpu_torch.config import apply_cli_overrides, device_from_gpu_ids, load_config
from bbdm_tpu_torch.models.factory import resolve_device
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
                        help="-1 runs on the CPU; N runs on CUDA card N; N,M,... one rank "
                             "per card")
    parser.add_argument("--port", type=str, default="12355",
                        help="rendezvous port of the ranks on 127.0.0.1")

    parser.add_argument("--resume_model", type=str, default=None, help="model checkpoint")
    parser.add_argument("--resume_optim", type=str, default=None, help="optimizer checkpoint")

    parser.add_argument("--max_epoch", type=int, default=None, help="cap training.n_epochs")
    parser.add_argument("--max_steps", type=int, default=None, help="cap training.n_steps")
    return parser.parse_args(argv)


def _run(args, local_rank: int = 0):
    """This process's rank: join the process group where the run has several
    ranks or several nodes, build the runner, train or test."""
    devices = device_from_gpu_ids(args.gpu_ids)
    nodes, node, coordinator = parallel.node_env(args.port)
    grouped = len(devices) > 1 or os.environ.get("BBDM_MULTIHOST") == "1"
    if grouped:
        parallel.initialize(node * len(devices) + local_rank, nodes * len(devices),
                            init_method=f"tcp://{coordinator}", local_size=len(devices),
                            device=devices[local_rank])
    try:
        config = apply_cli_overrides(load_config(args.config), args)
        runner = get_runner(config.runner, config)
        if args.train:
            runner.train()
        else:
            runner.test()
        return runner
    finally:
        if grouped:
            parallel.shutdown()


def _rank_main(local_rank: int, argv: list):
    _run(parse_args(argv), local_rank)


def main(argv=None):
    """Run the CLI; returns the runner when this process is the node's one
    rank, None after the ranks of several ``--gpu_ids`` have run in their
    own processes."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    devices = device_from_gpu_ids(args.gpu_ids)
    if len(devices) == 1:
        return _run(args)
    resolve_device(devices[0])  # no card: raise here, not in each rank
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(argv,), nprocs=len(devices), join=True)
    return None


if __name__ == "__main__":
    main()
