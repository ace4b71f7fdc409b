"""Convert reference PyTorch checkpoints to the JAX package's checkpoint
layout, without JAX (port of ``scripts/convert_checkpoint.py``).

    # full BBDM/LBBDM training checkpoint (model + EMA + counters + latent stats)
    python -m bbdm_tpu_torch.tools.convert_checkpoint bbdm \\
        -c configs/Template-LBBDM-f4.yaml -i top_model_epoch_X.pth -o converted/model.ckpt

    # bare LDM VQGAN first-stage checkpoint
    python -m bbdm_tpu_torch.tools.convert_checkpoint vqgan -i CelebAMaskHQ-f4.ckpt \\
        -o vqgan.ckpt

    # full taming/LDM VQGAN training checkpoint (autoencoder + discriminator +
    # LPIPS) -> VQGANRunner model_load_path + loss.lpips_weights
    python -m bbdm_tpu_torch.tools.convert_checkpoint vqgan-train -i CelebAMaskHQ-f4.ckpt \\
        -o vqgan_train.ckpt --lpips-out lpips_vgg.ckpt

The trees come from the port's ``checkpoints/torch_import.py`` and are written
by ``checkpoints/io.py`` as flax's msgpack, so both packages load them
(``--resume_model``, ``VQGAN.params.ckpt_path``, ``model_load_path``). Host
code only: it reads ``torch.load`` pickles, so convert only files you trust.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("kind", choices=["bbdm", "vqgan", "vqgan-train"])
    parser.add_argument("-c", "--config", type=str, default=None,
                        help="YAML config describing the model (bbdm kind)")
    parser.add_argument("-i", "--input", type=str, required=True, help="torch .pth/.ckpt")
    parser.add_argument("-o", "--output", type=str, required=True, help="output .ckpt")
    parser.add_argument("--lpips-out", type=str, default=None,
                        help="vqgan-train: also write the checkpoint's LPIPS "
                             "weights here (point loss.lpips_weights at it)")
    args = parser.parse_args(argv)
    if args.kind == "bbdm" and not args.config:
        parser.error("bbdm conversion needs -c/--config")
    return args


def _write(tree, path):
    from bbdm_tpu_torch.checkpoints.io import save_checkpoint

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_checkpoint(tree, path)
    print(f"wrote {path}")


def main(argv=None):
    from bbdm_tpu_torch.checkpoints.torch_import import (
        convert_ldm_vqgan_checkpoint,
        convert_reference_checkpoint,
        convert_vqgan_train_checkpoint,
    )

    args = parse_args(argv)
    lpips = None
    if args.kind == "bbdm":
        from bbdm_tpu_torch.config import load_config

        out = convert_reference_checkpoint(args.input, load_config(args.config).model)
    elif args.kind == "vqgan-train":
        out, lpips = convert_vqgan_train_checkpoint(args.input)
    else:
        out = {"vqgan": convert_ldm_vqgan_checkpoint(args.input)}
    _write(out, args.output)
    if args.kind == "vqgan-train":
        dc = out["disc_config"]
        print("discriminator geometry (set these in model.loss): "
              f"disc_num_layers={dc['disc_num_layers']} "
              f"use_actnorm={dc['use_actnorm']} disc_ndf={dc['disc_ndf']}")
        if lpips is None:
            print("no loss.perceptual_loss.* weights in the checkpoint")
        elif args.lpips_out:
            _write(lpips, args.lpips_out)
        else:
            print("checkpoint has LPIPS weights; pass --lpips-out to export")


if __name__ == "__main__":
    main()
