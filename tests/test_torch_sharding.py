"""FSDP and tensor parallelism of the port (``bbdm_tpu_torch/parallel/{mesh,
sharding,tensor}.py``) on the CPU: gloo ranks against the JAX package's step
on a mesh placed by ``bbdm_tpu.parallel.place_state``, and against one rank
of the port.

The ranks start once for the module (``tests/torch_sharding_worker.py``: two
ranks run every 2-rank scenario, four ranks the 2 x 2 one, at the same time)
while this process computes the JAX steps and the one-rank runs. Scenarios and
bars:

* (a) layout, no ranks: every leaf's placement of the tiny LBBDM and of the
  tiny Gumbel VQGAN with its BatchNorm PatchGAN, mapped to the JAX layout,
  equals ``bbdm_tpu.parallel.tp.leaf_spec`` on the JAX tree, for five
  (model_parallel, fsdp width) pairs;
* (b) FSDP on a 2 x 1 grid, (c) tensor parallelism on a 1 x 2 grid and (f)
  both on a 2 x 2 grid: the tiny LBBDM of ``test_torch_parallel.py``
  (accumulate 2, global batches of 4, the JAX draws of t and noise) against
  ``make_train_step`` jitted on ``place_state(mesh, state, model_parallel,
  fsdp)``, with the bars of ``test_torch_train_step.py``; (b) also holds each
  rank's persistent bytes to the shard sizes ``leaf_spec`` gives;
* (d) the VQGAN GAN step under FSDP and under tensor parallelism, 2 ranks
  against 1, with ``test_torch_parallel.py``'s bars;
* (e) a ``BBDMRunner`` epoch under each (a mid-training sample grid, a
  checkpoint): rank 0 alone writes; the checkpoint, in the full JAX layout,
  equals a one-rank run's within the step bars and resumes in the JAX runner
  (``mesh_devices: 1``) and in a one-rank port runner at its global step;
  ``sample_to_eval`` on the 1 x 2 grid: both ranks sample every row, model
  index 0 alone writes, and the tree is the one-rank run's within 1 uint8
  code.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_parallel_worker as pworker
import torch_sharding_worker as worker
from flax import serialization
from test_torch_parallel import (
    ACCUMULATE,
    BATCH,
    MICROBATCHES,
    free_port,
    join,
    load,
    one_thread,
    write_pairs,
)
from test_torch_train_step import EMA, assert_trees_close, assert_weights_close, model_config

import main_torch
from bbdm_tpu.config import apply_cli_overrides as jax_overrides
from bbdm_tpu.config import dict2namespace
from bbdm_tpu.config import load_config as jax_load_config
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu.parallel import make_mesh, place_state, shard_batch
from bbdm_tpu.parallel.tp import leaf_spec
from bbdm_tpu.runners.bbdm import BBDMRunner as JaxRunner
from bbdm_tpu.runners.vqgan import _VQGANTrainModel
from bbdm_tpu.training.ema import ema_init as jax_ema_init
from bbdm_tpu.training.optim import build_optimizer
from bbdm_tpu.training.plateau import plateau_init as jax_plateau_init
from bbdm_tpu.training.state import TrainState as JaxState
from bbdm_tpu.training.state import zeros_like_tree
from bbdm_tpu.training.step import make_train_step as jax_make_train_step
from bbdm_tpu_torch.checkpoints import io
from bbdm_tpu_torch.checkpoints.from_jax import LATENT_STATS, jax_tree_from_state_dict
from bbdm_tpu_torch.config import apply_cli_overrides, load_config, save_config
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.parallel.sharding import jax_dims, placement
from bbdm_tpu_torch.runners.bbdm import BBDMRunner

# (data width, model width, fsdp) of each JAX comparison
GRIDS = {"fsdp": (2, 1, True), "mp": (1, 2, False), "grid": (2, 2, True)}


def lbbdm_inputs(work):
    """``test_torch_parallel.lbbdm_inputs`` with the port's seeded weights on
    both sides (a jitted flax init of the UNet costs ~10 s of CPU): written
    for the ranks to ``lbbdm_in.pt``; returns what :func:`jax_lbbdm_steps`
    needs."""
    cfg = lbbdm_cfg()
    jm = jax_build(cfg)
    port = port_build(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = jax_tree_from_state_dict(dict(port.named_parameters()))
    rs = np.random.RandomState(1)
    stats = {k: rs.uniform(0.5, 1.5, (1, 1, 1, 3)).astype(np.float32) for k in LATENT_STATS}
    inp = {k: [] for k in ("x", "y", "t", "noise", "key")}
    rs = np.random.RandomState(2)
    for i in range(MICROBATCHES):
        x = rs.uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32)
        y = np.clip(-x + rs.uniform(-0.3, 0.3, x.shape), -1, 1).astype(np.float32)
        key = jax.random.PRNGKey(10 + i)
        # the draws of BrownianBridgeModel.loss at the global batch's latent shape
        t_rng, n_rng = jax.random.split(key)
        shape = jax.eval_shape(lambda p, x: jm.encode(p, x), params, x).shape
        for k, v in (("x", x), ("y", y), ("noise", np.asarray(jax.random.normal(n_rng, shape))),
                     ("t", np.asarray(jax.random.randint(t_rng, (BATCH,), 0,
                                                         jm.num_timesteps))), ("key", key)):
            inp[k].append(v)
    torch.save({"model": cfg.to_dict(), "state_dict": port.state_dict(), "stats": stats,
                "training": {"accumulate_grad_batches": ACCUMULATE}, "ema": EMA,
                **{k: inp[k] for k in ("x", "y", "t", "noise")}},
               os.path.join(work, "lbbdm_in.pt"))
    return cfg, jm, params, stats, inp


def jax_lbbdm_steps(cfg, jm, params, stats, inp, tag, microbatches):
    """The JAX step jitted on the mesh of ``GRIDS[tag]``, its state placed by
    ``place_state``: (host state, each batch's metrics)."""
    data, model, fsdp = GRIDS[tag]
    training = dict2namespace({"accumulate_grad_batches": ACCUMULATE})
    tx = build_optimizer(cfg.BB.optimizer, trainable_mask=jm.trainable_mask(params))
    mesh = make_mesh(jax.devices()[:data * model], model_parallel=model)
    jstate = place_state(mesh, JaxState(
        step=jnp.asarray(0, jnp.int32), params=params, ema_params=jax_ema_init(params),
        opt_state=tx.init(params), plateau=jax_plateau_init(cfg.BB.optimizer.lr),
        grad_accum=zeros_like_tree(params), latent_stats=stats), model, fsdp)
    jstep = jax.jit(jax_make_train_step(jm, tx, training, dict2namespace(EMA),
                                        cfg.BB.lr_scheduler))
    metrics = []
    for x, y, key in list(zip(inp["x"], inp["y"], inp["key"]))[:microbatches]:
        jstate, m = jstep(jstate, shard_batch(mesh, x), shard_batch(mesh, y), key)
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    return jax.tree_util.tree_map(np.asarray, jstate), metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharding"))
    write_pairs(os.path.join(work, "data"))
    lbbdm = lbbdm_inputs(work)
    ctxs = [mp.start_processes(worker.run, args=(n, free_port(), work), nprocs=n, join=False,
                               start_method="spawn") for n in (2, 4)]
    try:
        # the three XLA compiles overlap in threads (about half the time of one after another)
        with ThreadPoolExecutor(len(GRIDS)) as pool:
            steps = {tag: pool.submit(jax_lbbdm_steps, *lbbdm, tag,
                                      2 if tag == "grid" else MICROBATCHES) for tag in GRIDS}
            with one_thread():
                worker.vqgan_steps(0, work, "one")
                worker.runner_lifecycle(0, work, "one")
                worker.sample_to_eval(0, work, "one", n_epochs=1)
            jax_out = {tag: f.result() for tag, f in steps.items()}
    finally:
        for ctx in ctxs:
            join(ctx)
    return work, lbbdm, jax_out


# ------------------------------------------------------------------ layout

def port_leaves(model):
    """{JAX path: torch shape} of every placed leaf, with its port name."""
    from bbdm_tpu_torch.models.discriminator import BatchNorm2d

    leaves = dict(model.named_parameters())
    for m, mod in model.named_modules():
        if isinstance(mod, BatchNorm2d):
            leaves.update({f"{m}.{b}": t for b, t in mod.named_buffers(recurse=False)})
    out = {}
    for name, t in leaves.items():
        mod, leaf = name.rsplit(".", 1)
        if leaf == "weight":
            leaf = "kernel" if t.ndim in (2, 4) else "scale"
        if leaf in ("mean", "var"):  # flax batch_stats
            mod = mod.replace("discriminator.", "disc_stats.", 1)
        out[f"{mod}.{leaf}"] = (name, tuple(t.shape))
    return out


def jax_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_shapes(v, f"{prefix}{k}."))
        elif v is not None:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


@pytest.fixture(scope="module")
def layout_models():
    """(port model, JAX leaf shapes) of the tiny LBBDM and the tiny VQGAN."""
    cfg = lbbdm_cfg()
    lb = (port_build(cfg, device="cpu"),
          jax_shapes(jax.eval_shape(jax_build(cfg).init_params, jax.random.PRNGKey(0))))
    vq_cfg = dict2namespace(pworker._vqgan_model())
    vq = (port_build(vq_cfg, device="cpu"),
          jax_shapes(jax.eval_shape(_VQGANTrainModel(vq_cfg).init_params,
                                    jax.random.PRNGKey(0))))
    return {"lbbdm": lb, "vqgan": vq}


def lbbdm_cfg():
    return model_config("lbbdm", {"optimizer": "Adam"})


@pytest.mark.parametrize("model_size,fsdp_size", [(2, 1), (1, 2), (4, 1), (1, 8), (2, 2)])
@pytest.mark.parametrize("which", ["lbbdm", "vqgan"])
def test_every_leaf_follows_the_jax_leaf_spec(layout_models, which, model_size, fsdp_size):
    model, shapes = layout_models[which]
    leaves = port_leaves(model)
    assert sorted(leaves) == sorted(shapes)
    split = ties = 0
    for path, (name, shape) in leaves.items():
        dims = jax_dims(name, len(shape))
        assert tuple(shape[d] for d in dims) == shapes[path], path
        p = placement(name, shape, model_size, fsdp_size)
        got = [None] * len(shape)
        for axis, d in (("model", p.model), ("data", p.data)):
            if d is not None:
                got[dims.index(d)] = axis
        want = tuple(leaf_spec(np.zeros(shapes[path], np.int8), model_size, fsdp_size))
        assert tuple(got) == want + (None,) * (len(shape) - len(want)), path
        split += any(got)
        if p.data is not None:
            # a tie that the torch order would break on another dimension
            free = [d for d in range(len(shape)) if d != p.model]
            ties += next(d for d in free if shape[d] == shape[p.data]) != p.data
    assert split
    if model_size == 1 and fsdp_size > 1:
        assert ties


# -------------------------------------------------------------- LBBDM steps

def jax_persistent_bytes(params, jm, model_size, fsdp_size):
    """A rank's bytes under ``leaf_spec``: every parameter, and the moments,
    EMA and accumulator of the trainable ones (the port keeps no EMA of the
    frozen VQGAN and no moments for it, as optax.masked keeps none)."""
    mask = jax.tree_util.tree_leaves(jm.trainable_mask(params))

    def shard(x):
        spec = leaf_spec(x, model_size, fsdp_size)
        return x.size * 4 // (model_size if "model" in spec else 1) \
            // (fsdp_size if "data" in spec else 1)

    sizes = [shard(x) for x in jax.tree_util.tree_leaves(params)]
    return sum(sizes) + 4 * sum(s for s, m in zip(sizes, mask) if m)


@pytest.mark.parametrize("tag", list(GRIDS))
def test_sharded_lbbdm_update_matches_the_jax_mesh_step(runs, tag):
    work, (cfg, jm, params, stats, _), jax_out = runs
    jstate, metrics = jax_out[tag]
    data, model, fsdp = GRIDS[tag]
    ranks = [load(work, f"lbbdm_{tag}_rank{r}.pt") for r in range(data * model)]
    got = ranks[0]
    for other in ranks[1:]:
        for k, v in got["state_dict"].items():
            assert torch.equal(v, other["state_dict"][k]), k
        assert other["losses"] == got["losses"]
    steps = len(metrics)
    assert got["step"] == steps
    np.testing.assert_allclose(got["losses"], [float(m["loss"]) for m in metrics], atol=2e-4)
    assert got["lrs"] == [float(m["lr"]) for m in metrics]
    lr, updates = cfg.BB.optimizer.lr, steps // ACCUMULATE
    sd = got["state_dict"]
    assert_weights_close(jax_tree_from_state_dict(sd), jstate.params, lr, 2 * lr * updates)
    assert_weights_close(jax_tree_from_state_dict({**sd, **got["ema"]}), jstate.ema_params, lr,
                         2 * lr * updates)
    assert_trees_close(got["opt_state"], serialization.to_state_dict(jstate.opt_state), 1e-4,
                       2e-4, "opt_state")
    want_p = serialization.to_state_dict(jstate.plateau)
    for k in ("lr", "num_bad", "cooldown_count"):
        assert got["plateau"][k] == want_p[k], k
    np.testing.assert_allclose(got["plateau"]["best"], want_p["best"], rtol=1e-4, atol=2e-4)
    want_bytes = jax_persistent_bytes(params, jm, model, data if fsdp else 1)
    assert [r["bytes"] for r in ranks] == [want_bytes] * len(ranks)
    if tag == "fsdp":
        assert want_bytes < 0.55 * jax_persistent_bytes(params, jm, 1, 1)


# -------------------------------------------------------------- VQGAN steps

@pytest.mark.parametrize("tag", ["fsdp", "mp"])
def test_sharded_vqgan_step_matches_one_rank(runs, tag):
    """Losses, d_weight, the BatchNorm statistics and both players' weights."""
    work, _, _ = runs
    one = load(work, "vqgan_one_rank0.pt")
    two, other = (load(work, f"vqgan_{tag}_rank{r}.pt") for r in range(2))
    for a, b in zip(two["metrics"], one["metrics"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert two["metrics"] == other["metrics"]
    stats = [k for k in one["state_dict"] if k.endswith((".mean", ".var"))]
    assert len(stats) == 4
    for k in stats:
        np.testing.assert_allclose(two["state_dict"][k], one["state_dict"][k], atol=1e-5,
                                   err_msg=k)
    weights = [k for k in one["state_dict"] if k not in stats]
    assert_weights_close([two["state_dict"][k] for k in weights],
                         [one["state_dict"][k] for k in weights], pworker.VQ_LR,
                         2 * pworker.VQ_LR * pworker.VQ_STEPS)
    for k, v in two["state_dict"].items():
        assert torch.equal(v, other["state_dict"][k]), k


# ------------------------------------------------------------ the runner

def ckpt_dir(work, tag, rank=0):
    return os.path.join(work, f"run_{tag}_rank{rank}", "tiny", "tiny-lbbdm")


def resume(work, tag, tmp_path, jax_side, monkeypatch=None):
    """A one-rank runner (port or JAX, ``mesh_devices: 1``) resuming the run's
    last checkpoint. The JAX runner starts from zero weights of the right
    shapes (its random init runs op by op, ~30 s here): the checkpoint
    replaces them all."""
    cfg = worker.runner_config(work, tag, 0)
    cfg.training.mesh_devices = 1
    del cfg.args
    path = str(tmp_path / f"{tag}.yaml")
    save_config(cfg, path)
    ckpt = os.path.join(ckpt_dir(work, tag), "checkpoint")
    argv = ["-c", path, "--train", "--gpu_ids", "-1", "-r", str(tmp_path / "out"),
            "--resume_model", os.path.join(ckpt, "last_model.ckpt"),
            "--resume_optim", os.path.join(ckpt, "last_optim_sche.ckpt")]
    args = main_torch.parse_args(argv)
    if jax_side:
        from bbdm_tpu.models.latent import LatentBrownianBridgeModel as JaxLBBDM

        init = JaxLBBDM.init_params
        monkeypatch.setattr(JaxLBBDM, "init_params", lambda self, rng: jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(lambda r: init(self, r), rng)))
        return JaxRunner(jax_overrides(jax_load_config(path), args))
    return BBDMRunner(apply_cli_overrides(load_config(path), args))


@pytest.mark.parametrize("tag", ["fsdp", "mp"])
def test_sharded_runner_checkpoint_is_the_one_rank_one_in_the_jax_layout(runs, tag, tmp_path,
                                                                         monkeypatch):
    work, _, _ = runs
    ranks = [load(work, f"run_{tag}_rank{r}.pt") for r in range(2)]
    assert [r["grid"] for r in ranks] == [GRIDS[tag][:2]] * 2
    assert {r["global_step"] for r in ranks} == {load(work, "run_one_rank0.pt")["global_step"]}
    assert not os.path.exists(ckpt_dir(work, tag, 1))
    assert os.listdir(os.path.join(ckpt_dir(work, tag), "image")) == ["1"]
    names = ("last_model.ckpt", "last_optim_sche.ckpt")
    got, want = ([io.load_checkpoint(os.path.join(ckpt_dir(work, t), "checkpoint", n))
                  for n in names] for t in (tag, "one"))
    assert got[0]["step"] == want[0]["step"] and got[0]["epoch"] == want[0]["epoch"]
    lr = worker.runner_config(work, tag, 0).model.BB.optimizer.lr
    for k in ("model", "ema"):
        assert_weights_close(got[0][k], want[0][k], lr, 2 * lr)
    assert_trees_close(got[1]["optimizer"][0], want[1]["optimizer"][0], 1e-4, 2e-4, "opt")

    jr = resume(work, tag, tmp_path, jax_side=True, monkeypatch=monkeypatch)
    assert jr.global_step == int(jr.state.step) == got[0]["step"]
    host = lambda t: jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(t))
    assert_trees_close(host(jr.state.params), got[0]["model"], 0, 0, "jax params")
    port = resume(work, tag, tmp_path, jax_side=False)
    assert port.global_step == port.state.step == got[0]["step"]
    model_states, optim_states = port.get_checkpoint_states()
    assert_trees_close(model_states["ema"], got[0]["ema"], 0, 0, "port ema")
    assert_trees_close(optim_states["optimizer"][0], got[1]["optimizer"][0], 0, 0, "port opt")


def test_tensor_parallel_sample_to_eval_is_written_by_model_index_0(runs):
    from test_torch_parallel import png_tree

    work, _, _ = runs
    written = [load(work, f"s2e_mp_rank{r}.pt") for r in range(2)]
    assert written[1] == [] and sorted(written[0]) == sorted(load(work, "s2e_one_rank0.pt"))
    base = os.path.join("tiny", "tiny-lbbdm", "sample_to_eval")
    two, one = (png_tree(os.path.join(work, f"s2e_{t}", base)) for t in ("mp", "one"))
    assert sorted(two) == sorted(one) and len(one) == 4 * (2 + 2)
    for k in one:
        assert np.abs(two[k].astype(int) - one[k]).max() <= 1, k
