"""A seeded random-backbone FID InceptionV3 weight file (port of
``scripts/make_random_inception.py``).

Without network access pytorch_fid's ``pt_inception-2015-12-05`` weights
cannot be fetched. For runs that close the FID protocol over a
``sample_to_eval`` tree (``preprocess_and_evaluation_torch.py -f FID``) this
writes seeded random weights as a torch ``.pth`` state dict of the port's
``FIDInceptionV3`` (pytorch_fid's names), which ``evaluation/fid.py``'s loader
reads strictly (``BBDM_FID_WEIGHTS`` or ``weights_path``):

* the module is built after ``torch.manual_seed(seed)``, then every conv kernel
  is He re-initialised (kaiming-normal, relu gain), in state-dict order: the
  stack is ~90 convolutions deep with BatchNorm at identity, so the gain per
  layer must be ~1 (torch's default init collapses the pool3 features to ~0,
  and a larger gain overflows fp32);
* BatchNorm weights, biases and statistics stay at identity.

The same seed gives the JAX script's weights: the module draws as the
script's test mirror does. Random-feature FID ranks image sets; it is not the
canonical metric: use real weights where they exist.

    python -m bbdm_tpu_torch.tools.random_inception [--out $TMPDIR/fid_inception_rand.pth] \\
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
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "fid_inception_rand.pth"))
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def random_state_dict(seed: int) -> dict:
    import torch

    from bbdm_tpu_torch.evaluation.inception import FIDInceptionV3

    torch.manual_seed(seed)
    sd = FIDInceptionV3().state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k.endswith(".conv.weight"):
                torch.nn.init.kaiming_normal_(v, nonlinearity="relu")
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
