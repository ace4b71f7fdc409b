"""The cross-attention LBBDM's cell (``lbbdm_f4_sd1unet.sample.b8n1``): its
reference against the program at a tiny size, its frozen FLOP count, its
kernel calls against the program's walk, and its files found by name, run
end to end at a tiny size on the CPU."""

import copy
import json
import os
import time
from collections import Counter

import pytest
import torch

from benchmark import harness, xattn_counts
from benchmark.reference import model as R
from benchmark.reference import xattn as X
from benchmark.weights import make_weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "lbbdm_f4_sd1unet.sample.b8n1"
NEW_METRICS = ["unet_attention_roofline.sample", "unet_attention_time_share.sample",
               "attention_fused_share.sample"]


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs", "lbbdm_f4_sd1unet.json")) as f:
        return json.load(f)


def _tiny_sd(tiny):
    """The tests' tiny LBBDM with the SD v1 UNet's shape: four levels, a
    transformer at factors 1, 2, 4, 8 heads, no FiLM, conv resampling, a
    one-stage SpatialRescaler context; a 16^2 latent."""
    cfg = copy.deepcopy(tiny)
    u = _config()["model"]["BB"]["params"]["UNetParams"]
    cfg["model"]["BB"]["params"]["UNetParams"] = dict(u, image_size=16, model_channels=64)
    cfg["model"]["BB"]["params"]["sample_step"] = 3
    cfg["model"]["CondStageParams"]["n_stages"] = 1
    return cfg


def test_reference_unet_matches_the_program(tiny):
    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.models import build_model

    cfg = _tiny_sd(tiny)
    weights = make_weights(X.param_specs(cfg["model"]), 7, "cpu")
    model = build_model(dict2namespace(cfg).model, device="cpu").eval()
    model.load_state_dict(weights, strict=True)
    P, ops = R.Params(weights), R.Ops()
    g = torch.Generator().manual_seed(0)
    x_cond = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    with torch.no_grad():
        ctx = X.context(P, ops, x_cond, cfg["model"])
        y = R.vq_encode(P, ops, x_cond, cfg["model"]["VQGAN"]["params"])
        t = torch.tensor([3, 40])
        torch.testing.assert_close(
            model.unet(y, t, model.get_cond_stage_context(x_cond)),
            X.unet(P, ops, y, t, ctx, cfg["model"]["BB"]["params"]["UNetParams"]),
            rtol=2e-4, atol=2e-4)


def test_flops_are_frozen_at_the_published_widths():
    """987 GFLOP a forward of one 64^2 latent (torch's FLOP counter on the
    program's UNet, which counts what this count counts), 840.4M parameters."""
    cfg = _config()["model"]
    assert xattn_counts.unet_forward(cfg) == 986_647_756_800
    assert xattn_counts.sample_batch(cfg, 8, 1) == pytest.approx(1.58677e15, rel=1e-5)
    unet = {k: s for k, (s, _) in X.param_specs(cfg).items() if k.startswith("unet.")}
    assert sum(torch.Size(s).numel() for s in unet.values()) == 840_429_443


def test_flops_equal_torchs_counter_on_the_program(tiny):
    from torch.utils.flop_counter import FlopCounterMode

    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.models.unet import UNet

    cfg = _tiny_sd(tiny)
    u = dict2namespace(cfg).model.BB.params.UNetParams
    net = UNet.from_config(u, "SpatialRescaler", dtype=torch.float32, device="cpu").train()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, 3, 16, 16), torch.zeros(1, dtype=torch.long),
            torch.zeros(1, 3, 16, 16))
    assert counter.get_total_flops() == xattn_counts.unet_forward(cfg["model"])


def test_kernel_calls_equal_the_programs_walk():
    import chip_smoke
    from bbdm_tpu_torch.config import dict2namespace

    d = _config()
    mine = xattn_counts.kernel_calls(d["model"], 8)
    theirs = chip_smoke.kernel_calls(dict2namespace(d).model, 8)
    short = {"group_norm": "K1", "upsample_conv": "K2", "flash_attention": "K3"}
    for part in ("encoder", "decoder", "unet"):
        got = Counter()
        for (k, key), n in mine[part].items():
            got[short[k], key[:4] if k == "group_norm" else key] += n
        assert got == theirs[part], part
    k3 = {key: n for (k, key), n in mine["unet"].items() if k == "flash_attention"}
    assert k3 == {(8, 8, 4096, 40, 4096): 10, (8, 8, 1024, 80, 1024): 5,
                  (8, 8, 1024, 80, 4096): 5, (8, 8, 256, 160, 4096): 5}


def test_cell_files_are_found_by_name_and_a_tiny_traced_run_is_correct(tiny):
    from benchmark import run

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, CELL, ROOT)
    assert cell.traffic["entry"] == "sample_to_eval_xattn"
    assert cell.config["model"]["BB"]["params"]["UNetParams"]["model_channels"] == 320
    assert [m["name"] for m in cell.metrics[0]] == ["sample_images_per_s", "setup_s"]
    assert set(NEW_METRICS) <= {m["name"] for m in cell.metrics[1]}
    for other in ("lbbdm_f4.sample.b32n1", "lbbdm_f16.sample.b8n1"):
        assert harness.Cell(bench, other, ROOT).traffic["entry"] == "sample_to_eval"
    cell.config = _tiny_sd(tiny)
    cell.traffic = dict(cell.traffic, batch=2, trace_batch=0)  # traced whatever the CPU's pace
    line, _ = run.run(cell, 2 ** 31 + 9, 1.0, 1, torch.device("cpu"),
                      t_start=time.perf_counter())
    assert line["correct"] is True, line["checks"]
    # the CPU runs every attention on the plain path and no kernel
    assert line["metrics"]["attention_fused_share.sample"]["value"] == 0.0
    assert "unet_attention_roofline.sample" not in line["metrics"]
    assert "unet_attention_time_share.sample" not in line["metrics"]


def test_a_traced_run_reaches_its_traced_batch_after_the_window(tiny):
    """A program whose batches outlast ``--seconds`` still runs the traced
    batch in a traced run; an untraced run starts no batch after them."""
    from benchmark import run
    from benchmark.entries import sample_to_eval as E
    from benchmark.entries import sample_to_eval_xattn as EX

    pool = [{"x_name": ["a"], "x_cond_name": ["a"]}]
    for last, want in ((1, 2), (-1, 0)):
        loader = EX.Loader(pool, 0.0, last)
        loader.opened = time.perf_counter()
        assert [b["x_name"] for b in loader] == [["b00000_000"], ["b00001_000"]][:want]
    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), CELL, ROOT)
    cell.config = _tiny_sd(tiny)
    cell.traffic = dict(cell.traffic, batch=2)
    line, _ = run.run(cell, 2 ** 31 + 11, 0.0, 1, torch.device("cpu"),
                      t_start=time.perf_counter())
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == 2 * 2 and "busy_s" in line["device"]  # batch 1 was traced
    assert E.Loader is not EX.Loader and E.Loader.__module__ == E.__name__


def test_new_metrics_read_kernels_by_compiled_head_dim():
    from benchmark.roofline import bound_s

    calls = Counter({("flash_attention", (8, 8, 4096, 40, 4096)): 10,
                     ("flash_attention", (8, 1, 4096, 512, 4096)): 1})
    trace = {"calls": calls, "elsize": 2, "busy_s": 0.1,
             "op_s": {"void (anonymous namespace)::flash_attention_kernel<64>(CUtensorMap_st)":
                      0.02,
                      "void (anonymous namespace)::flash_attention_kernel<512>(CUtensorMap_st)":
                      0.001}}
    metric = lambda n: harness.load_module(os.path.join(ROOT, "benchmark", "metrics", f"{n}.py"),
                                           "m_" + n.replace(".", "_"))
    want = 100 * 10 * bound_s("flash_attention", (8, 8, 4096, 40, 4096), 2) / 0.02
    assert metric("unet_attention_roofline.sample").read({"trace": trace}) == pytest.approx(want)
    assert metric("unet_attention_time_share.sample").read({"trace": trace}) == \
        pytest.approx(20.0)
    routes = {"kernel": [25, 99.0], "plain": [7, 1.0]}
    assert metric("attention_fused_share.sample").read({"attention_routes": routes}) == 99.0
    assert metric("attention_fused_share.sample").read({}) is None


@pytest.mark.gpu
def test_control_fails_the_cells_limits(card):
    from benchmark import control_xattn

    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), CELL, ROOT)
    readings = control_xattn.sample_readings(cell, 2 ** 31 + 23, card)
    assert any(readings[k] > limit for k, limit in cell.limits.items() if k in readings), readings


def test_control_reads_the_cells_numbers_at_a_tiny_size(tiny):
    from benchmark import control_xattn

    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), CELL, ROOT)
    cell.config = _tiny_sd(tiny)
    cell.traffic = dict(cell.traffic, batch=2)
    readings = control_xattn.sample_readings(cell, 2 ** 31 + 23, torch.device("cpu"))
    assert readings["latent_rel_err"] > 0 and readings["png_mean_levels"] >= 0


def test_a_program_without_the_small_head_rule_is_walked_under_its_own():
    """No roofline counts calls the kernel did not serve: a program from
    before the rule sends only the VQGAN's D = 512 attention to it."""
    cfg = _config()["model"]
    assert xattn_counts.program_takes_small_heads()
    old = xattn_counts.kernel_calls(cfg, 8, small_heads=False)
    assert not any(k == "flash_attention" for k, _ in old["unet"])
    assert {key for k, key in old["encoder"] if k == "flash_attention"} == \
        {(8, 1, 4096, 512, 4096)}
