"""A seeded random-backbone AlexNet-LPIPS weight file (port of
``scripts/make_random_lpips.py``).

Without network access the ``lpips.LPIPS(net='alex')`` weights cannot be
fetched. For runs that close the diversity and ``max_min_LPIPS`` protocols
over a multi-draw ``sample_to_eval`` tree this writes seeded random weights,
as the JAX script does:

* ``LPIPS("alex")`` built after ``torch.manual_seed(seed)``;
* conv kernels scaled by 0.05 and biases zeroed, so five stacked fp32 convs
  stay finite;
* the linear heads' weights made non-negative (lpips trains them so; the
  distance stays a semi-metric >= 0).

The JAX script writes the JAX package's tree (``.ckpt``); this writes the torch
``.pth`` state dict in lpips's layout (``net.slice{k}.{idx}.weight``,
``lin{k}.model.1.weight``, ``shift``, ``scale``), which ``evaluation/lpips.py``'s
loader reads strictly (``BBDM_LPIPS_WEIGHTS`` or ``weights_path``). The same
seed gives the same weights as the script: the module draws as the script's
test mirror does. Random-feature LPIPS ranks pairs; it is not the canonical
metric: use real weights where they exist.

    python -m bbdm_tpu_torch.tools.random_lpips [--out $TMPDIR/lpips_alex_rand.pth] \\
        [--seed 3] [--cpu]

The weights are made on the host. As every entry point of the port, the
command takes the CUDA card and raises where there is none, unless ``--cpu``
is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "lpips_alex_rand.pth"))
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def random_state_dict(seed: int) -> dict:
    import torch

    from bbdm_tpu_torch.evaluation.lpips import LPIPS

    torch.manual_seed(seed)
    sd = LPIPS("alex").state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k.startswith("net.") and k.endswith(".weight"):
                v.mul_(0.05)
            elif k.startswith("net."):
                v.zero_()
            elif k.startswith("lin"):
                v.abs_()
    return sd


def main(argv=None) -> str:
    import torch

    from bbdm_tpu_torch.models.factory import resolve_device

    args = parse_args(argv)
    resolve_device("cpu" if args.cpu else "cuda")
    torch.save(random_state_dict(args.seed), args.out)
    print(f"wrote {args.out} (seed {args.seed})")
    return args.out


if __name__ == "__main__":
    main()
