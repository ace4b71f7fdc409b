"""VQGAN reconstruction ceiling: roundtrip a directory of images through a
trained first stage and report PSNR/SSIM against the originals (port of
``scripts/eval_vqgan_recon.py``).

A latent bridge can at best reproduce what its frozen first stage can
reconstruct, so the roundtrip metric of the first stage is the ceiling for any
sample-vs-ground-truth pixel metric of the full model. Run it against the
``ground_truth`` directory of a ``sample_to_eval`` tree.

    python -m bbdm_tpu_torch.tools.vqgan_recon \\
        --config configs/runs/LBBDM-f4-syn256.yaml --vq-ckpt vqgan/last_model.ckpt \\
        --data results/.../sample_to_eval/ground_truth --out results/vq_recon [--fp32] [--cpu]

Images (``.png``, ``.jpg``, ``.jpeg``) are read with the port's ``read_image``,
scaled to [-1, 1] and roundtripped in batches of ``--batch`` through
``VQModel.roundtrip`` (encode, quantize, decode: the path of
``LatentBrownianBridgeModel.sample_vqgan``) in bf16, or fp32 with ``--fp32``,
on the CUDA card (raises where there is none) or, with ``--cpu``, the CPU.
Each reconstruction is written as a PNG under its input's name in ``--out``
(the JAX script lets Pillow pick the format from the name), then
``calc_psnr_ssim`` scores ``--out`` against ``--data``; one JSON line is
printed with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="configs/runs/LBBDM-f4-syn256.yaml")
    ap.add_argument("--vq-ckpt", required=True)
    ap.add_argument("--data", required=True, help="directory of images to roundtrip")
    ap.add_argument("--out", default="results/vq_recon")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=0, help="0 = all")
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 compute (default: bf16, the sampling-path dtype)")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def load_vqgan(config, path, *, dtype, device):
    """The config's ``VQGAN.params`` first stage with the weights of a JAX-layout
    checkpoint (a bare ``{"vqgan": ...}`` tree or a model checkpoint)."""
    from bbdm_tpu_torch.checkpoints.from_jax import state_dict_from_jax
    from bbdm_tpu_torch.checkpoints.io import extract_vqgan_tree, load_checkpoint
    from bbdm_tpu_torch.models.vqgan import VQModel

    model = VQModel.from_config(config.model.VQGAN.params, dtype=dtype, device=device)
    tree = extract_vqgan_tree(load_checkpoint(path))
    model.load_state_dict(state_dict_from_jax(tree, model))
    return model.eval()


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from bbdm_tpu_torch.config import load_config
    from bbdm_tpu_torch.evaluation import calc_psnr_ssim
    from bbdm_tpu_torch.models.factory import resolve_device
    from bbdm_tpu_torch.utils.images import read_image, save_single_image

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    config = load_config(args.config)
    model = load_vqgan(config, args.vq_ckpt,
                       dtype=torch.float32 if args.fp32 else torch.bfloat16, device=device)
    names = sorted(n for n in os.listdir(args.data)
                   if n.lower().endswith((".png", ".jpg", ".jpeg")))
    if args.limit:
        names = names[:args.limit]
    os.makedirs(args.out, exist_ok=True)
    for i in range(0, len(names), args.batch):
        chunk = names[i:i + args.batch]
        imgs = np.stack([read_image(os.path.join(args.data, n)).astype(np.float32) / 127.5 - 1.0
                         for n in chunk])
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).to(device)
        rec = model.roundtrip(x).float().permute(0, 2, 3, 1).cpu().numpy()
        for n, r in zip(chunk, rec):
            save_single_image(r, args.out, n, to_normal=True)
    metrics = calc_psnr_ssim(args.out, args.data)
    line = {"metric": "VQGAN roundtrip reconstruction (pixel-metric ceiling)",
            "vq_ckpt": args.vq_ckpt, "data": args.data, "count": len(names),
            **{k: round(float(v), 4) for k, v in metrics.items()}}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
