"""The readings that set each limit's upper end, at a cell's own size:

    python3 benchmark/control.py --workload lbbdm_f4.sample.b32n1 --seeds 11 12 13

The control is the reference put in the program's place, one precision below
the configuration's bf16 (``reference/lowp.py``: float8 e4m3 operands), and
judged by the cell's own comparison, the functions that decide ``correct``
in a run (``entries/sample_to_eval.py`` ``judge``, ``entries/train_step.py``
``compare``), on the inputs a run with that seed would check. For a training
cell it also reads the fault of half the batch left out (the loss the mean
over the first half of each microbatch's rows), over the start and over the
checked window update, which the control follows from the float32
reference's own state after the start. The program is not run. One JSON line
per seed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sample_readings(cell, seed, device, batches=3):
    """The control's readings on the draws a run with ``seed`` that did
    ``batches`` batches would check."""
    import torch

    from benchmark.entries import sample_to_eval as E
    from benchmark.entries.common import reference_weights
    from benchmark.reference import model as R
    from benchmark.reference.lowp import Fp8Ops

    tr, model_cfg = cell.traffic, cell.config["model"]
    vq, bb = model_cfg["VQGAN"]["params"], model_cfg["BB"]["params"]
    lat = vq["ddconfig"]["resolution"] // 2 ** (len(vq["ddconfig"]["ch_mult"]) - 1)
    pool = E.make_pool(seed, tr, cell.config["data"]["dataset_config"]["image_size"])
    rows, chosen, draws = E.plan(seed, batches, tr)
    shape = (tr["sample_num"], len(R.sampling_steps(bb)), tr["batch"], vq["embed_dim"], lat, lat)
    x_cond, noise, _ = E.checked_inputs(pool, seed, rows, chosen, draws, shape, device)
    P, ctl = reference_weights(R.param_specs(model_cfg), seed, device), Fp8Ops()
    with torch.no_grad():
        z_ctl = R.sample_latent(P, ctl, R.vq_encode(P, ctl, x_cond, vq), noise, model_cfg)
        img = R.vq_decode(P, ctl, R.vq_quantize(P, z_ctl, vq), vq).permute(0, 2, 3, 1)
    return E.judge(P, model_cfg, x_cond, noise, z_ctl, E.to_uint8(img.cpu().numpy()))


def train_readings(cell, seed, device):
    import torch

    from benchmark.entries import train_step as E
    from benchmark.reference import model as R
    from benchmark.reference.lowp import Fp8Ops

    model_cfg, tr = cell.config["model"], cell.traffic
    specs = R.param_specs(model_cfg)
    vq = model_cfg["VQGAN"]["params"]
    lat = vq["ddconfig"]["resolution"] // 2 ** (len(vq["ddconfig"]["ch_mult"]) - 1)
    size = cell.config["data"]["dataset_config"]["image_size"]
    st = dict(cfg=cell.config, specs=specs, seed=seed, batch=tr["batch"],
              latent_shape=(vq["embed_dim"], lat, lat),
              pool=E._pool(seed, tr["pool"], size, device),
              names=[k for k in specs if k.startswith("unet.")])
    ctx = dict(traffic=tr, device=device)
    ref = E.reference_run(st, ctx)
    count = tr["compared_updates"]
    first = count * tr["accumulate"] + E.check_update(seed, tr) * tr["accumulate"]
    window_args = (ref["before"], count, model_cfg["BB"]["optimizer"]["lr"], first)
    window_ref = E.follow_update(st, ctx, *window_args)

    def readings(start, window):
        out = {}
        for prefix, run, against in (("", start, ref), ("window_", window, window_ref)):
            run = dict(run, grad=[float(g.norm()) for g in run["grad"]])
            got = E.compare(run, against)
            out.update({prefix + k: got[k] for k in ("loss_rel_gap", "grad_norm_gap",
                                                     "update_norm_gap")})
            out[prefix + "worst"] = [st["names"][i] for i in got["worst"]]
        return out

    ctl = Fp8Ops()
    out = {"control": readings(E.reference_run(st, ctx, ctl),
                               E.follow_update(st, ctx, *window_args, ops=ctl))}
    torch.cuda.empty_cache()
    feed = E._feed

    def half(st_, i):
        x, y, t, noise = feed(st_, i)
        h = x.shape[0] // 2
        return x[:h], y[:h], t[:h], noise[:h]

    E._feed = half
    try:
        out["half_batch"] = readings(E.reference_run(st, ctx), E.follow_update(st, ctx, *window_args))
    finally:
        E._feed = feed
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import time

    import torch

    from benchmark import harness

    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")),
                        args.workload, ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    fn = train_readings if cell.traffic["entry"] == "train_step" else sample_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = fn(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
