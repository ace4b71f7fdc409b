"""The Stable Diffusion v1 UNet as LBBDM-f4's denoiser
(``benchmark/configs/lbbdm_f4_sd1unet.json``), on the CPU.

The port against the benchmark's plain reference of that model
(``benchmark/reference/xattn.py``) at a tiny size of its shape: four levels,
a transformer at factors 1, 2 and 4, 8 heads, no FiLM, conv resampling, a
SpatialRescaler context concatenated and attended to, a 16^2 latent, batch 2,
seeded weights, fp32 within 2e-4: one UNet forward and a 3-step bridge
sample. The CUDA dispatch, walked on the meta device at full width: the
templates' flash-attention calls are the JAX package's rule's, and the SD v1
widths send 25 of their 32 attentions to the kernel. The attention route
counters count a replayed step as its capture, and each SpatialTransformer
forward is a ``unet.transformer`` span.
"""

import copy
import json
import os
import sys
from collections import Counter

import pytest
import torch

import chip_smoke
from bbdm_tpu_torch import ops
from bbdm_tpu_torch.config import dict2namespace
from bbdm_tpu_torch.models import bridge
from bbdm_tpu_torch.ops import attention
from bbdm_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.reference import model as R  # noqa: E402
from benchmark.reference import xattn as X  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402

TINY = harness.load_module(os.path.join(ROOT, "benchmark", "tests", "conftest.py"),
                           "bench_tests_conftest").TINY
SD_UNET = {"image_size": 16, "in_channels": 6, "model_channels": 64, "out_channels": 3,
           "num_res_blocks": 2, "attention_resolutions": [4, 2, 1], "channel_mult": [1, 2, 4, 4],
           "conv_resample": True, "dims": 2, "num_heads": 8, "num_head_channels": -1,
           "use_scale_shift_norm": False, "resblock_updown": False,
           "use_spatial_transformer": True, "transformer_depth": 1, "context_dim": 3,
           "condition_key": "SpatialRescaler"}


def tiny_sd():
    """The benchmark tests' tiny LBBDM (32^2 images, a 16^2 latent) with an
    SD-v1-shaped UNet and a one-stage SpatialRescaler context."""
    cfg = copy.deepcopy(TINY)
    cfg["model"]["BB"]["params"]["UNetParams"] = dict(SD_UNET)
    cfg["model"]["BB"]["params"]["sample_step"] = 3
    cfg["model"]["CondStageParams"]["n_stages"] = 1
    return cfg


def benchmark_config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    from bbdm_tpu_torch.models import build_model

    cfg = tiny_sd()
    specs = X.param_specs(cfg["model"])
    weights = make_weights(specs, 11, "cpu")
    model = build_model(dict2namespace(cfg).model, device="cpu").eval()
    model.load_state_dict(weights, strict=True)
    return model, R.Params(weights), cfg["model"]


def test_reference_specs_are_the_ports_parameters(port):
    model, _, model_cfg = port
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: shape for k, (shape, _) in X.param_specs(model_cfg).items()}


def test_unet_forward_and_bridge_sample_match_the_reference(port):
    model, P, model_cfg = port
    ops_ = R.Ops()
    g = torch.Generator().manual_seed(3)
    x_cond = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    with torch.no_grad():
        ctx = model.get_cond_stage_context(x_cond)
        torch.testing.assert_close(ctx, X.context(P, ops_, x_cond, model_cfg),
                                   rtol=2e-4, atol=2e-4)
        y = model.encode(x_cond)
        t = torch.tensor([7, 31])
        u = model_cfg["BB"]["params"]["UNetParams"]
        torch.testing.assert_close(model.unet(y, t, ctx), X.unet(P, ops_, y, t, ctx, u),
                                   rtol=2e-4, atol=2e-4)
        noise = [torch.randn(y.shape, generator=g) for _ in range(model.noised_steps())]
        got = model.p_sample_loop(y, ctx, noise=noise, clip_denoised=False)
        want = X.sample_latent(P, ops_, y, ctx, noise, model_cfg)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _k3(calls):
    return Counter({key: n for key, n in calls.items() if key[0] == "K3"})


def _jax_rule(Tq, Tk, D, dtype):
    return Tq >= attention.KERNEL_MIN_SEQ and D % 128 == 0


@pytest.mark.parametrize("name", ["lbbdm_f4", "lbbdm_f16"])
def test_templates_flash_attention_calls_are_the_jax_rules(name, monkeypatch):
    """The benchmark's template cells keep every attention on its route: the
    kernel calls under the CUDA rule equal those under the JAX package's."""
    model_cfg = dict2namespace(benchmark_config(name)["model"])
    got = {part: _k3(c) for part, c in chip_smoke.kernel_calls(model_cfg, 8).items()}
    monkeypatch.setattr(attention, "flash_route", _jax_rule)
    want = {part: _k3(c) for part, c in chip_smoke.kernel_calls(model_cfg, 8).items()}
    assert got == want


def test_sd1_widths_send_25_of_32_attentions_to_the_kernel(monkeypatch):
    """Level 0 self and cross (D 40), level 1 self and cross (D 80) and level
    2 cross (D 160, 256 queries over 4096 keys) go to K3; level 2 self and
    the middle transformer's two stay plain."""
    model_cfg = dict2namespace(benchmark_config("lbbdm_f4_sd1unet")["model"])
    calls = chip_smoke.kernel_calls(model_cfg, 8)
    routed = _k3(calls["unet"])
    assert routed == Counter({("K3", (8, 8, 4096, 40, 4096)): 10,
                              ("K3", (8, 8, 1024, 80, 1024)): 5,
                              ("K3", (8, 8, 1024, 80, 4096)): 5,
                              ("K3", (8, 8, 256, 160, 4096)): 5})
    assert _k3(calls["encoder"]) == _k3(calls["decoder"]) == \
        Counter({("K3", (8, 1, 4096, 512, 4096)): 1})
    monkeypatch.setattr(attention, "flash_route", lambda *a: True)  # every attention
    every = _k3(chip_smoke.kernel_calls(model_cfg, 8)["unet"])
    assert sum(every.values()) == 32
    assert every - routed == Counter({("K3", (8, 8, 64, 160, 64)): 1,
                                      ("K3", (8, 8, 64, 160, 4096)): 1,
                                      ("K3", (8, 8, 256, 160, 256)): 5})


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def replay(self):
        pass


def test_attention_counters_are_added_back_on_a_replayed_step(monkeypatch):
    """A captured step (CUDA's stream and graph calls stood in for on the
    CPU) leaves the route counters as they were, and each replay adds what
    one eager step adds: calls and FLOPs of each route, launches too."""
    import contextlib

    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    q = torch.randn(1, 2, 64, 16)
    k = torch.randn(1, 2, 32, 16)

    def body(x, y, context, row, eps):
        attention.multi_head_attention(q, k, k)
        attention.multi_head_attention(q, q, q)
        attention.flash_attention_cuda.launches += 1  # a kernel launch, as K3 counts one
        return x + eps, x

    y = torch.zeros(2, 3)
    before = ops.read_counts()
    body(y, y, None, y, y)
    per_step = [b - a for a, b in zip(before, ops.read_counts())]
    routes = {n: (t.calls, t.flops) for n, t in attention.ROUTES.items()}
    step = bridge._StepGraph(body, y, None, torch.zeros(4))
    assert {n: (t.calls, t.flops) for n, t in attention.ROUTES.items()} == routes
    for _ in range(2):
        at = ops.read_counts()
        step(torch.zeros(4), torch.ones(2, 3))
        assert [b - a for a, b in zip(at, ops.read_counts())] == per_step
    assert attention.ROUTES["plain"].calls - routes["plain"][0] == 4
    assert attention.ROUTES["plain"].flops - routes["plain"][1] == \
        2 * 4 * 2 * 64 * (32 + 64) * 16


def test_each_spatial_transformer_is_a_span(port):
    model, _, model_cfg = port
    spans.clear()
    y = torch.zeros(1, 3, 16, 16)
    with torch.no_grad():
        model.unet(y, torch.tensor([3]), torch.zeros(1, 3, 16, 16))
    recs = spans.records()
    forward = [r for r in recs if r.name == "unet.forward"]
    blocks = [r for r in recs if r.name == "unet.transformer"]
    assert len(forward) == 1 and len(blocks) == 16
    assert all(r.parent == forward[0].index for r in blocks)
