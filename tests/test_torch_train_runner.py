"""The port's training runner against the JAX package's, on the CPU, and the
gradient path through the kernels' autograd Functions.

* ``get_latent_mean_std`` on a tiny PNG dataset against the JAX runner's
  (the same frozen VQGAN checkpoint; the two-pass mean of per-batch means,
  then of per-batch squared deviations): within 1e-5.
* Checkpoints both ways: a port checkpoint (model and optimizer files, after
  two train steps) loads into the JAX runner through its own
  ``flax.serialization.from_state_dict`` and gives the same loss (2e-4) and
  trees; a JAX runner's checkpoint resumes in the port with equal counters,
  parameters, EMA, moments and plateau state (exactly: the bytes carry over).
  The same both ways under ``training.fuse_small_leaves`` (the bucketed
  optimizer layout), where the port's next update equals the JAX runner's
  within 2e-4; an optimizer state of the other layout, or a bucket of another
  model, is refused.
* With every dispatcher forced through its kernel branch (the twins as
  kernels), every trainable parameter gets a finite gradient, each UNet
  GroupNorm's backward is the Function's recompute, and the VQGAN gets none;
  a kernel that returned a detached tensor (the fault the Functions close)
  makes the train step raise instead of training only part of the model.
* A sample in the middle of training leaves the model as it found it.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from test_latent import lbbdm_config

import main_torch
from bbdm_tpu.checkpoints import io as jax_io
from bbdm_tpu.config import apply_cli_overrides as jax_overrides
from bbdm_tpu.config import load_config as jax_load_config
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu.runners.bbdm import BBDMRunner as JaxRunner
from bbdm_tpu_torch.checkpoints import io
from bbdm_tpu_torch.checkpoints.from_jax import (
    LATENT_STATS,
    jax_tree_from_state_dict,
    latent_stats_to_jax,
    opt_state_to_jax,
    plateau_to_jax,
)
from bbdm_tpu_torch.config import apply_cli_overrides, dict2namespace, load_config, save_config
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.models.layers import GroupNorm32, UpsampleConv3x3
from bbdm_tpu_torch.ops import attention, group_norm, upsample_conv
from bbdm_tpu_torch.runners.bbdm import BBDMRunner
from bbdm_tpu_torch.training.step import make_train_step
from bbdm_tpu_torch.utils.images import write_png
from tests.conftest import tiny_bbdm_config


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


FUSE = 4096  # the fused config's fuse_threshold: UNet kernels of mc 64 stay per leaf


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 16^2 custom_aligned PNG dataset (4 train, 2 val, 2 test pairs), a
    JAX-initialised VQGAN checkpoint, and YAML configs of a tiny LBBDM
    (SpatialRescaler, normalize_latent, EMA) and a tiny pixel BBDM (Adam with
    weight decay), batch 2."""
    root = tmp_path_factory.mktemp("train")
    rs = np.random.RandomState(0)
    for stage, n in (("train", 4), ("val", 2), ("test", 2)):
        for side in "AB":
            os.makedirs(root / "data" / stage / side)
            for i in range(n):
                write_png(str(root / "data" / stage / side / f"p{i}.png"),
                          rs.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    lb = lbbdm_config("SpatialRescaler", normalize_latent=True)
    vq = jax.tree_util.tree_map(np.asarray, jax.jit(jax_build(lb).init_params)(
        jax.random.PRNGKey(3))["vqgan"])
    jax_io.save_checkpoint({"vqgan": vq}, str(root / "vq.ckpt"))
    lb.VQGAN.params.ckpt_path = str(root / "vq.ckpt")
    px = tiny_bbdm_config()
    px.BB.optimizer.weight_decay = 0.01
    # two channels per GroupNorm group (see tests/test_torch_train_step.py:
    # at one, Adam turns the rounding noise of a zero gradient into a step)
    fused = lbbdm_config("SpatialRescaler")
    fused.VQGAN.params.ckpt_path = lb.VQGAN.params.ckpt_path
    fused.BB.params.UNetParams.model_channels = 64
    paths = {}
    for name, model in (("lbbdm", lb), ("bbdm", px), ("fused", fused)):
        d = model.to_dict()
        d["EMA"] = {"use_ema": True, "ema_decay": 0.9, "update_ema_interval": 1,
                    "start_ema_step": 0}
        size = 8 if name == "bbdm" else 16
        bucket = {"fuse_small_leaves": True, "fuse_threshold": FUSE} if name == "fused" else {}
        cfg = {"runner": "BBDMRunner",
               "training": {"n_epochs": 2, "n_steps": 100, "save_interval": 1,
                            "sample_interval": 1, "validation_interval": 1,
                            "accumulate_grad_batches": 1, **bucket},
               "testing": {"clip_denoised": False, "sample_num": 1},
               "data": {"dataset_name": "tiny", "dataset_type": "custom_aligned",
                        "dataset_config": {"dataset_path": str(root / "data"),
                                           "image_size": size, "channels": 3,
                                           "to_normal": True, "flip": False},
                        "train": {"batch_size": 2, "shuffle": True},
                        "val": {"batch_size": 2, "shuffle": True}, "test": {"batch_size": 2}},
               "model": d}
        paths[name] = str(root / f"{name}.yaml")
        save_config(dict2namespace(cfg), paths[name])
    return root, paths


def runners(path, out, *extra, jax_side=True):
    """(port runner, JAX runner or None) for ``main.py --train`` flags on the CPU."""
    argv = ["-c", path, "--train", "--gpu_ids", "-1", "-r", str(out), *extra]
    port = BBDMRunner(apply_cli_overrides(load_config(path), main_torch.parse_args(argv)))
    if not jax_side:
        return port, None
    return port, JaxRunner(jax_overrides(jax_load_config(path), main_torch.parse_args(argv)))


def test_latent_mean_std_matches_the_jax_runner(setup):
    root, paths = setup
    port, jr = runners(paths["lbbdm"], root / "stats")
    got = latent_stats_to_jax(port.latent_stats)
    for k in LATENT_STATS:
        np.testing.assert_allclose(got[k], np.asarray(jr.state.latent_stats[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert port.state.latent_stats is port.latent_stats


def batch_of(size, seed):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    return x, np.clip(-x + rs.uniform(-0.3, 0.3, x.shape), -1, 1).astype(np.float32)


def test_port_checkpoint_loads_in_the_jax_runner(setup, tmp_path):
    """Two port train steps, the model and optimizer files written; the JAX
    runner resumes from them through ``from_state_dict`` (it raises on any
    structural mismatch) and holds the same trees and loss."""
    root, paths = setup
    port, _ = runners(paths["lbbdm"], tmp_path / "a", jax_side=False)
    cfg = port.config
    step = make_train_step(port.model.train(), cfg.training, cfg.model.EMA,
                           port.lr_scheduler_config)
    for i in range(2):
        x, y = batch_of(16, i)
        step(port.state, nchw(x), nchw(y), port.train_generator)
    port.global_epoch = 1
    model_states, optim_states = port.get_checkpoint_states()
    io.save_checkpoint(model_states, str(tmp_path / "m.ckpt"))
    io.save_checkpoint(optim_states, str(tmp_path / "o.ckpt"))

    _, jr = runners(paths["lbbdm"], tmp_path / "b", "--resume_model", str(tmp_path / "m.ckpt"),
                    "--resume_optim", str(tmp_path / "o.ckpt"))
    assert (jr.global_epoch, jr.global_step, int(jr.state.step)) == (2, 2, 2)
    host = lambda t: jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(t))
    assert_trees_equal(host(jr.state.params), model_states["model"])
    assert_trees_equal(host(jr.state.ema_params), model_states["ema"])
    assert_trees_equal(host(jr.state.opt_state), optim_states["optimizer"][0])
    assert_trees_equal(host(jr.state.plateau), optim_states["scheduler"][0])
    assert_trees_equal({k: np.asarray(v) for k, v in jr.state.latent_stats.items()},
                       {k: model_states[k] for k in LATENT_STATS})

    x, y = batch_of(16, 7)
    key = jax.random.PRNGKey(9)
    jm = jr.model
    loss, _ = jm.loss(jr.state.params, key, x, y, latent_stats=jr.state.latent_stats)
    t_rng, n_rng = jax.random.split(key)
    zshape = jax.eval_shape(lambda p, x: jm.encode(p, x), jr.state.params, x).shape
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, jm.num_timesteps)))
    ploss, _ = port.model.loss(nchw(x), nchw(y), latent_stats=port.latent_stats, t=t,
                               noise=nchw(jax.random.normal(n_rng, zshape)))
    assert abs(ploss.item() - float(loss)) <= 2e-4


def test_jax_checkpoint_resumes_in_the_port(setup, tmp_path):
    """Two JAX train steps (Adam with weight decay: its state behind the empty
    ``add_decayed_weights`` entry), the JAX runner's checkpoint dicts written;
    the port resumes with equal counters, weights, EMA, moments and plateau."""
    root, paths = setup
    _, jr = runners(paths["bbdm"], tmp_path / "a")
    for i in range(2):
        x, y = batch_of(8, i)
        jr.state, _ = jr._train_step(jr.state, x, y, jax.random.PRNGKey(i))
    jr.global_step, jr.global_epoch = 2, 0
    model_states, optim_states = jr.get_checkpoint_states()
    jax_io.save_checkpoint(model_states, str(tmp_path / "m.ckpt"))
    jax_io.save_checkpoint(optim_states, str(tmp_path / "o.ckpt"))

    port, _ = runners(paths["bbdm"], tmp_path / "b", "--resume_model",
                      str(tmp_path / "m.ckpt"), "--resume_optim", str(tmp_path / "o.ckpt"),
                      jax_side=False)
    assert (port.global_epoch, port.global_step, port.state.step) == (1, 2, 2)
    want = jax_io.load_checkpoint(str(tmp_path / "m.ckpt"))
    sd = port.model.state_dict()
    assert_trees_equal(jax_tree_from_state_dict(sd), want["model"])
    assert_trees_equal(jax_tree_from_state_dict({**sd, **port.state.ema}), want["ema"])
    want_o = jax_io.load_checkpoint(str(tmp_path / "o.ckpt"))
    assert_trees_equal(opt_state_to_jax(port.state.optimizer, port.model),
                       want_o["optimizer"][0])
    assert_trees_equal(plateau_to_jax(port.state.plateau), want_o["scheduler"][0])


def jax_draws(jm, params, key, x):
    """(t, noise) of ``jm.loss`` under ``key``, for the port's ``loss``."""
    t_rng, n_rng = jax.random.split(key)
    zshape = jax.eval_shape(lambda p, x: jm.encode(p, x), params, x).shape
    return (torch.from_numpy(np.array(jax.random.randint(t_rng, (x.shape[0],), 0,
                                                         jm.num_timesteps))),
            nchw(jax.random.normal(n_rng, zshape)))


def test_a_bucketed_jax_checkpoint_resumes_in_the_port(setup, tmp_path):
    """Two JAX train steps under ``training.fuse_small_leaves`` (the moments
    as {"bucket", "big"}, frozen VQGAN leaves {} in "big"); the port resumes
    with moments equal to the file's, and its next update on the same batch
    and draws equals the JAX runner's within 2e-4."""
    root, paths = setup
    _, jr = runners(paths["fused"], tmp_path / "a")
    for i in range(2):
        jr.state, _ = jr._train_step(jr.state, *batch_of(16, i), jax.random.PRNGKey(i))
    jr.global_step, jr.global_epoch = 2, 0
    model_states, optim_states = jr.get_checkpoint_states()
    mu = optim_states["optimizer"][0]["inner_state"]["0"]["mu"]
    big = list(mu["big"].values())
    assert mu["bucket"].size and {type(v) is dict and not v for v in big} == {True, False}
    jax_io.save_checkpoint(model_states, str(tmp_path / "m.ckpt"))
    jax_io.save_checkpoint(optim_states, str(tmp_path / "o.ckpt"))

    port, _ = runners(paths["fused"], tmp_path / "b", "--resume_model",
                      str(tmp_path / "m.ckpt"), "--resume_optim", str(tmp_path / "o.ckpt"),
                      jax_side=False)
    assert port.fuse_threshold() == FUSE
    assert_trees_equal(opt_state_to_jax(port.state.optimizer, port.model, FUSE),
                       jax_io.load_checkpoint(str(tmp_path / "o.ckpt"))["optimizer"][0])

    x, y = batch_of(16, 5)
    key = jax.random.PRNGKey(5)
    t, noise = jax_draws(jr.model, jr.state.params, key, x)
    jr.state, metrics = jr._train_step(jr.state, x, y, key)
    cfg = port.config
    step = make_train_step(port.model.train(), cfg.training, cfg.model.EMA,
                           port.lr_scheduler_config)
    out = step(port.state, nchw(x), nchw(y), t=t, noise=noise)
    assert abs(float(out["loss"]) - float(metrics["loss"])) <= 2e-4
    got = jax.tree_util.tree_leaves(jax_tree_from_state_dict(port.model))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jr.state.params))
    assert len(got) == len(want)
    assert max(float(np.abs(a - b).max()) for a, b in zip(got, want)) <= 2e-4


def test_a_bucketed_port_checkpoint_resumes_in_the_jax_runner(setup, tmp_path):
    """Two port train steps under ``training.fuse_small_leaves``; the JAX
    runner of the same config resumes from the files through its own
    ``from_state_dict`` (which raises on any other tree) with equal trees."""
    root, paths = setup
    port, _ = runners(paths["fused"], tmp_path / "a", jax_side=False)
    cfg = port.config
    step = make_train_step(port.model.train(), cfg.training, cfg.model.EMA,
                           port.lr_scheduler_config)
    for i in range(2):
        x, y = batch_of(16, i)
        step(port.state, nchw(x), nchw(y), port.train_generator)
    port.global_epoch = 1
    model_states, optim_states = port.get_checkpoint_states()
    assert "bucket" in optim_states["optimizer"][0]["inner_state"]["0"]["mu"]
    io.save_checkpoint(model_states, str(tmp_path / "m.ckpt"))
    io.save_checkpoint(optim_states, str(tmp_path / "o.ckpt"))

    _, jr = runners(paths["fused"], tmp_path / "b", "--resume_model", str(tmp_path / "m.ckpt"),
                    "--resume_optim", str(tmp_path / "o.ckpt"))
    assert jr.bucketer is not None and (jr.global_epoch, jr.global_step) == (2, 2)
    host = lambda t: jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(t))
    assert_trees_equal(host(jr.state.params), model_states["model"])
    assert_trees_equal(host(jr.state.opt_state), optim_states["optimizer"][0])


@pytest.mark.parametrize("fault", ["per-leaf-under-fuse", "bucketed-without-fuse",
                                   "bucket-of-another-length"])
def test_an_optimizer_state_of_another_layout_is_refused(setup, tmp_path, fault):
    """An optimizer state that fits neither form the config names raises rather
    than loading into the wrong leaves: the per-leaf layout under
    ``fuse_small_leaves``, the bucketed one without it, a bucket of another
    length."""
    root, paths = setup
    port, _ = runners(paths["fused"], tmp_path / "a", jax_side=False)
    model_states, optim_states = port.get_checkpoint_states()
    node = optim_states["optimizer"][0]["inner_state"]
    if fault == "per-leaf-under-fuse":
        optim_states["optimizer"][0] = opt_state_to_jax(port.state.optimizer, port.model)
    elif fault == "bucket-of-another-length":
        node["0"]["mu"]["bucket"] = node["0"]["mu"]["bucket"][1:]
    io.save_checkpoint(model_states, str(tmp_path / "m.ckpt"))
    io.save_checkpoint(optim_states, str(tmp_path / "o.ckpt"))
    resume = ("--resume_model", str(tmp_path / "m.ckpt"), "--resume_optim",
              str(tmp_path / "o.ckpt"))
    if fault == "bucketed-without-fuse":
        cfg = load_config(paths["fused"])
        cfg.training.fuse_small_leaves = False
        path = str(tmp_path / "per-leaf.yaml")
        save_config(cfg, path)
    else:
        path = paths["fused"]
    match = "bucket of" if fault == "bucket-of-another-length" else "fuse_small_leaves"
    with pytest.raises(ValueError, match=match):
        runners(path, tmp_path / "b", *resume, jax_side=False)


@pytest.fixture
def kernels_forced(monkeypatch):
    """Every dispatcher takes its kernel branch on the CPU; the kernels are the
    plain versions, K1's forward and backward counted; K2 must not run in
    training."""
    def counting(fn):
        def wrapper(*a, **kw):
            wrapper.launches += 1
            return fn(*a, **kw)

        wrapper.launches = 0
        return wrapper

    def no_k2(*a, **kw):
        raise AssertionError("K2 ran in training")

    for mod in (group_norm, attention, upsample_conv):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
    monkeypatch.setattr(group_norm, "group_norm_cuda", counting(group_norm.group_norm_plain))
    monkeypatch.setattr(attention, "flash_attention_cuda", counting(attention.attention_plain))
    monkeypatch.setattr(upsample_conv, "upsample_conv_cuda", no_k2)
    monkeypatch.setattr(group_norm, "group_norm_bwd_cuda",
                        counting(group_norm.group_norm_backward_plain))
    return monkeypatch


@pytest.mark.parametrize("kind", ["bbdm", "lbbdm-sr"])
def test_every_trainable_parameter_gets_a_finite_gradient_through_the_functions(
        kernels_forced, kind):
    cfg = tiny_bbdm_config() if kind == "bbdm" else lbbdm_config("SpatialRescaler")
    model = port_build(cfg, device="cpu").train()
    size = 8 if kind == "bbdm" else 16
    x, y = batch_of(size, 4)
    loss, _ = model.loss(nchw(x), nchw(y), generator=torch.Generator().manual_seed(0))
    loss.backward()
    trainable = model.trainable_parameters()
    assert trainable and all(p.grad is not None and torch.isfinite(p.grad).all()
                             for p in trainable.values())
    assert all(p.grad is None for n, p in model.named_parameters() if n not in trainable)
    n_norms = sum(isinstance(m, GroupNorm32) for m in model.unet.modules())
    assert group_norm.group_norm_bwd_cuda.launches == n_norms  # one backward per UNet norm
    assert group_norm.group_norm_cuda.launches >= n_norms


def test_a_kernel_that_cuts_the_graph_makes_the_step_raise(kernels_forced):
    """The fault the Functions close: a kernel called directly returns a
    tensor without a grad_fn, the parameters in front of every GroupNorm get
    no gradient, and the train step refuses to update."""
    kernels_forced.setattr(group_norm, "needs_grad", lambda *t: False)
    cut = group_norm.group_norm_cuda
    kernels_forced.setattr(group_norm, "group_norm_cuda", lambda *a, **kw: cut(*a, **kw).detach())
    cfg = tiny_bbdm_config()
    model = port_build(cfg, device="cpu").train()
    from bbdm_tpu_torch.training.optim import Optimizer
    from bbdm_tpu_torch.training.plateau import plateau_init
    from bbdm_tpu_torch.training.state import TrainState

    params = model.trainable_parameters()
    state = TrainState(step=0, params=params, ema=None,
                       optimizer=Optimizer(cfg.BB.optimizer, params), plateau=plateau_init(1e-4))
    step = make_train_step(model, dict2namespace({"accumulate_grad_batches": 1}))
    x, y = batch_of(8, 5)
    with pytest.raises(RuntimeError, match="graph was cut"):
        step(state, nchw(x), nchw(y), torch.Generator().manual_seed(0))


def test_a_sample_in_the_middle_of_training_leaves_the_model_as_it_was():
    """The sampler switches to eval mode and hoists the subpixel kernels for
    its call only: afterwards the model is in training mode again, no combined
    kernel is left on any UpsampleConv3x3 and the training loss is unchanged."""
    cfg = lbbdm_config("SpatialRescaler")
    model = port_build(cfg, device="cpu").train()
    x, y = batch_of(16, 6)
    t, noise = torch.tensor([3, 11]), torch.randn(2, 3, 8, 8, generator=torch.Generator()
                                                  .manual_seed(1))
    before = model.loss(nchw(x), nchw(y), t=t, noise=noise)[0]
    model.sample(nchw(y), generator=torch.Generator().manual_seed(2))
    assert model.training and model.unet.training and not model.vqgan.training
    assert all(m.combined is None for m in model.modules() if isinstance(m, UpsampleConv3x3))
    assert torch.equal(model.loss(nchw(x), nchw(y), t=t, noise=noise)[0], before)
