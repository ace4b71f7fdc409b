"""The sampler's captured reverse step (``models/bridge.py``) against its
eager loop, on the card (marker ``gpu``, skipped without one).

With the same noise the graph loop gives the eager loop's result bit for
bit: an LBBDM-f16-shaped loop (the benchmark's configuration, batch 8, a
16^2 x 8 latent, 200 euler steps), an LBBDM-f4-shaped one at batch 2, heun
at 20 steps, the trajectory of ``sample_mid_step``, and draws from a seeded
generator. A second call replays the first call's capture; weights changed
between calls are seen; a new batch size captures again, and the cache keeps
the two shapes used last. The kernels' launch counters read after a graph
loop what they read after the eager loop, and a replayed call makes no
synchronising call. For each objective the graph loop gives, bit for bit,
the loop written as it was before its step took tensors: Python-float
coefficients and int timesteps. No jax is imported, so on a machine without jax it runs
with ``python -m pytest tests/test_torch_step_graph.py -m gpu --noconftest``.
"""

import json
import os

import pytest
import torch

from bbdm_tpu_torch import ops
from bbdm_tpu_torch.models import bridge
from bbdm_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured as a CUDA graph only there")
    return torch.device("cuda")


def config(name, **bb):
    from bbdm_tpu_torch.config import dict2namespace

    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["model"]["BB"]["params"].update(bb)
    return dict2namespace(cfg).model


def build(cfg, device):
    from bbdm_tpu_torch.models import build_model

    model = build_model(cfg, device=device)
    model.unet_params = cfg.BB.params.UNetParams
    return model


@pytest.fixture(scope="module")
def f16(cuda):
    return build(config("lbbdm_f16"), cuda)


def inputs(model, batch, seed=0):
    """(y, the noise of every step) at the UNet's latent shape, from ``seed``."""
    u = model.unet_params
    shape = (batch, u.out_channels, u.image_size, u.image_size)
    g = torch.Generator(model._m_t.device).manual_seed(seed)
    y = torch.randn(shape, generator=g, device=g.device)
    return y, [torch.randn(shape, generator=g, device=g.device)
               for _ in range(model.noised_steps())]


def eager(monkeypatch, fn):
    """``fn()`` with the step graph turned off (the loop the CPU runs)."""
    with monkeypatch.context() as m:
        m.setattr(bridge, "_graph_steps", lambda y: False)
        return fn()


def captures():
    return len([r for r in spans.records() if r.name == "sampler.capture"])


def test_f16_loop_equals_the_eager_loop(f16, monkeypatch):
    y, noise = inputs(f16, 8)
    f16.release_step_graphs()
    spans.clear()
    got = f16.p_sample_loop(y, noise=noise, clip_denoised=False)
    want = eager(monkeypatch, lambda: f16.p_sample_loop(y, noise=noise, clip_denoised=False))
    assert captures() == 1 and len(f16.coeffs.steps) == 200
    assert torch.equal(got, want)
    recs = spans.records()
    replays = [r for r in recs if r.name == "sampler.replay"]
    assert len(replays) == 200  # the eager call replays nothing
    capture, = [r for r in recs if r.name == "sampler.capture"]
    print(f"capture (a warm-up step and the capture): {(capture.end - capture.start) / 1e9:.3f} s")


def test_second_call_replays_and_sees_new_weights(f16, monkeypatch):
    y, noise = inputs(f16, 8, seed=1)
    f16.release_step_graphs()
    spans.clear()
    f16.p_sample_loop(y, noise=noise, clip_denoised=False)
    w = next(p for p in f16.unet.parameters() if p.ndim == 4)  # the first conv
    saved = w.detach().clone()
    try:
        with torch.no_grad():
            w.mul_(1.5)
        got = f16.p_sample_loop(y, noise=noise, clip_denoised=False)
        assert captures() == 1
        want = eager(monkeypatch, lambda: f16.p_sample_loop(y, noise=noise,
                                                            clip_denoised=False))
        assert torch.equal(got, want)
        # a swap of the storage, as the EMA's swapped_in does it
        swapped = saved.clone()
        w.data, swapped = swapped, w.data
        got = f16.p_sample_loop(y, noise=noise, clip_denoised=False)
        want = eager(monkeypatch, lambda: f16.p_sample_loop(y, noise=noise,
                                                            clip_denoised=False))
        assert torch.equal(got, want) and captures() == 1
    finally:
        with torch.no_grad():
            w.data = saved


def test_generator_draws_equal_the_eager_draws(f16, monkeypatch):
    y, _ = inputs(f16, 8, seed=2)
    run = lambda: f16.p_sample_loop(  # noqa: E731
        y, generator=torch.Generator(y.device).manual_seed(11), clip_denoised=True)
    got = run()
    assert torch.equal(got, eager(monkeypatch, run))


def test_mid_step_trajectory_equals_the_eager_one(f16, monkeypatch):
    y, noise = inputs(f16, 8, seed=3)
    run = lambda: f16.p_sample_loop(y, noise=noise, sample_mid_step=True)  # noqa: E731
    got = run()
    want = eager(monkeypatch, run)
    assert got[0].shape == (200, *y.shape)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_new_batch_size_captures_again_and_the_cache_keeps_two(f16, monkeypatch):
    """The cache keeps the shapes used last: after 8, 4, 8 it holds 4 and 8,
    so 2 evicts 4 and 4 evicts 8."""
    f16.release_step_graphs()
    spans.clear()
    for batch, seen in ((8, 1), (4, 2), (8, 2), (2, 3), (4, 4), (8, 5)):
        y, noise = inputs(f16, batch, seed=batch)
        got = f16.p_sample_loop(y, noise=noise, clip_denoised=False)
        assert captures() == seen, batch
        assert len(f16._step_graphs) <= bridge.GRAPHS_KEPT
    want = eager(monkeypatch, lambda: f16.p_sample_loop(y, noise=noise, clip_denoised=False))
    assert torch.equal(got, want)


def launches():
    return [getattr(f, attr) for f, attr in ops.REPLAYED_COUNTS if attr == "launches"]


def test_launch_counters_count_replays_as_the_eager_launches(f16, monkeypatch):
    y, noise = inputs(f16, 8, seed=4)
    before = launches()
    eager(monkeypatch, lambda: f16.p_sample_loop(y, noise=noise))
    per_call = [b - a for a, b in zip(before, launches())]
    assert sum(per_call) > 0
    f16.release_step_graphs()
    for _ in range(2):  # the capturing call, then a replaying one
        before = launches()
        f16.p_sample_loop(y, noise=noise)
        assert [b - a for a, b in zip(before, launches())] == per_call


def test_replayed_call_never_synchronises(f16):
    y, noise = inputs(f16, 8, seed=5)
    f16.p_sample_loop(y, noise=noise)  # captured, if it was not
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f16.p_sample_loop(y, noise=noise)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_heun_loop_equals_the_eager_loop(cuda, monkeypatch):
    model = build(config("lbbdm_f16", sampler="heun", sample_step=20), cuda)
    y, noise = inputs(model, 8, seed=6)
    for mid in (False, True):
        run = lambda: model.p_sample_loop(y, noise=noise, sample_mid_step=mid)  # noqa: E731
        got, want = run(), eager(monkeypatch, run)
        got, want = (got, want) if mid else ((got,), (want,))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_f4_loop_equals_the_eager_loop(cuda, monkeypatch):
    model = build(config("lbbdm_f4"), cuda)
    y, noise = inputs(model, 2, seed=7)
    got = model.p_sample_loop(y, noise=noise, clip_denoised=False)
    want = eager(monkeypatch, lambda: model.p_sample_loop(y, noise=noise, clip_denoised=False))
    assert torch.equal(got, want)
    model.release_step_graphs()
    assert not model._step_graphs and model._static_weights is None
    del model


def python_float_loop(model, y, noise, clip_denoised):
    """The euler loop as the sampler wrote it before its step took tensors:
    Python-float coefficients, int32 timesteps, ``/ (1.0 - m_t)`` for the
    'noise' objective."""
    from torch.func import functional_call

    c, params = model.coeffs, model._sampling_params()
    context = None if model.condition_key == "nocond" else y
    x_t = y
    with torch.inference_mode(), model._sampling_mode():
        for i in range(len(c.steps)):
            tt = torch.full((y.shape[0],), int(c.steps[i]), dtype=torch.int32, device=y.device)
            pred = functional_call(model.unet, params, (x_t, tt, context)).to(y.dtype)
            m_t, sigma_t = float(c.m_t[i]), float(c.sigma_fwd[i])
            if model.objective == "grad":
                x0 = x_t - pred
            elif model.objective == "noise":
                x0 = (x_t - m_t * y - sigma_t * pred) / (1.0 - m_t)
            else:
                x0 = y - pred
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            x_t = (float(c.a_xt[i]) * x_t + float(c.a_x0[i]) * x0 + float(c.a_y[i]) * y
                   + float(c.sigma[i]) * noise[i])
    return x_t


@pytest.mark.parametrize("objective", ["grad", "noise", "ysubx"])
def test_graph_loop_equals_the_python_float_loop(cuda, objective):
    model = build(config("lbbdm_f16", objective=objective, sample_step=20), cuda)
    y, noise = inputs(model, 8, seed=8)
    for clip in (False, True):
        got = model.p_sample_loop(y, noise=noise, clip_denoised=clip)
        assert torch.equal(got, python_float_loop(model, y, noise, clip)), clip
    del model
