"""The readings that set the cross-attention cell's limits' upper ends, at its
own size (``control.py`` for ``reference/xattn.py``'s model):

    python3 benchmark/control_xattn.py --workload lbbdm_f4_sd1unet.sample.b8n1 --seeds 11 12 13

The control is that reference put in the program's place, one precision
below the configuration's bf16 (``reference/lowp.py``: float8 e4m3 operands
of every conv, linear and attention), judged by the cell's own comparison
(``entries/sample_to_eval_xattn.py`` ``judge``) on the inputs a run with that
seed would check. The program is not run. One JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sample_readings(cell, seed, device, batches=3):
    """The control's readings on the draws a run with ``seed`` that did
    ``batches`` batches would check."""
    import torch

    from benchmark.entries import sample_to_eval as E
    from benchmark.entries import sample_to_eval_xattn as EX
    from benchmark.entries.common import reference_weights
    from benchmark.reference import model as R
    from benchmark.reference import xattn as X
    from benchmark.reference.lowp import Fp8Ops

    tr, model_cfg = cell.traffic, cell.config["model"]
    vq, bb = model_cfg["VQGAN"]["params"], model_cfg["BB"]["params"]
    lat = vq["ddconfig"]["resolution"] // 2 ** (len(vq["ddconfig"]["ch_mult"]) - 1)
    pool = E.make_pool(seed, tr, cell.config["data"]["dataset_config"]["image_size"])
    rows, chosen, draws = E.plan(seed, batches, tr)
    shape = (tr["sample_num"], len(R.sampling_steps(bb)), tr["batch"], vq["embed_dim"], lat, lat)
    x_cond, noise, _ = E.checked_inputs(pool, seed, rows, chosen, draws, shape, device)
    P, ctl = reference_weights(X.param_specs(model_cfg), seed, device), Fp8Ops()
    with torch.no_grad():
        ctx = X.context(P, ctl, x_cond, model_cfg)
        z_ctl = X.sample_latent(P, ctl, R.vq_encode(P, ctl, x_cond, vq), ctx, noise, model_cfg)
        img = R.vq_decode(P, ctl, R.vq_quantize(P, z_ctl, vq), vq).permute(0, 2, 3, 1)
    return EX.judge(P, model_cfg, x_cond, noise, z_ctl, E.to_uint8(img.cpu().numpy()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    from benchmark import harness

    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                        args.workload, ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = sample_readings(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
