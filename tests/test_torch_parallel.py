"""Data parallelism of the port (``bbdm_tpu_torch/parallel``) on the CPU: two
ranks over gloo against the JAX package's step on a 2-device mesh and against
one rank of the port.

The two ranks start once for the module (``tests/torch_parallel_worker.py``
runs every scenario in them) while this process computes the JAX step and the
one-rank runs. Scenarios and bars:

* the loader's node shards against ``bbdm_tpu.data.DataLoader(shard_count,
  shard_index)``, and the ranks' rows against the node's batch: exact;
* a tiny LBBDM (SpatialRescaler, latent statistics, EMA, plateau) with
  ``accumulate_grad_batches`` 2 over 4 global batches of 4, each rank fed its
  rows of the JAX draws of t and noise, against ``make_train_step`` jitted on a
  2-device mesh with the batches sharded over it: the bars of
  ``test_torch_train_step.py`` (loss 2e-4; parameters and EMA within lr / 10
  but for one element in 10^4, all within 2 lr per update; moments 2e-4
  absolute plus 1e-4 relative; the plateau's counters and lr exactly); the two
  ranks' weights equal, bit for bit;
* a tiny VQGAN (Gumbel quantizer, BatchNorm PatchGAN, ``disc_start`` 0) over
  3 global batches of 4, 2 ranks against 1: losses and d_weight 1e-4
  relative, the BatchNorm running statistics 1e-5, the parameters with the
  bars above (lr 1e-4); the same through ``VQGANRunner`` (a step, a
  validation epoch, ``sample_to_eval``): validation loss 1e-5 relative, the
  reconstructions within 1 uint8 code;
* ``sample_to_eval`` of a tiny LBBDM (eta 1, 2 draws) on 2 ranks against 1:
  the same files, each PNG within 1 uint8 code;
* training that rank 0's stop file ends: both ranks stop after the same step
  (a SIGTERM on rank 1 alone stops nothing) with the same validation losses
  and weights; only rank 0 writes its result tree and its profile trace of
  the window.
"""

import contextlib
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_parallel_worker as worker
from test_torch_train_step import (
    EMA,
    assert_trees_close,
    assert_weights_close,
    model_config,
)

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.data.loader import DataLoader as JaxLoader
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu.parallel import make_mesh, replicate, shard_batch
from bbdm_tpu.training.ema import ema_init as jax_ema_init
from bbdm_tpu.training.optim import build_optimizer
from bbdm_tpu.training.plateau import plateau_init as jax_plateau_init
from bbdm_tpu.training.state import TrainState as JaxState
from bbdm_tpu.training.state import zeros_like_tree
from bbdm_tpu.training.step import make_train_step as jax_make_train_step
from bbdm_tpu_torch.checkpoints.from_jax import (
    LATENT_STATS,
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from bbdm_tpu_torch.data import DataLoader
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.utils.images import read_png, write_png

RANKS, MICROBATCHES, ACCUMULATE, BATCH = 2, 4, 2, 4


@contextlib.contextmanager
def one_thread():
    """torch on one thread for the block, as the ranks run: the suite's
    workers already hold every core, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_pairs(root, n=4, size=16):
    rs = np.random.RandomState(0)
    for stage in ("train", "val", "test"):
        for side in "AB":
            os.makedirs(os.path.join(root, stage, side))
            for i in range(n):
                write_png(os.path.join(root, stage, side, f"p{i}.png"),
                          rs.randint(0, 256, (size, size, 3)).astype(np.uint8))


def write_images(root, n=4, size=16):
    rs = np.random.RandomState(1)
    for stage in ("train", "val", "test"):
        os.makedirs(os.path.join(root, stage))
        for i in range(n):
            write_png(os.path.join(root, stage, f"im{i}.png"),
                      rs.randint(0, 256, (size, size, 3)).astype(np.uint8))


def lbbdm_inputs(work):
    """The tiny LBBDM's JAX initial weights, the global batches and the draws
    the JAX step takes from each batch's key, written for the ranks to
    ``lbbdm_in.pt``; returns what :func:`jax_lbbdm_steps` needs."""
    cfg = model_config("lbbdm", {"optimizer": "Adam"})
    jm = jax_build(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
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
    port = port_build(cfg, device="cpu")
    torch.save({"model": cfg.to_dict(), "state_dict": state_dict_from_jax(params, port),
                "stats": stats, "training": {"accumulate_grad_batches": ACCUMULATE},
                "ema": EMA, **{k: inp[k] for k in ("x", "y", "t", "noise")}},
               os.path.join(work, "lbbdm_in.pt"))
    return cfg, jm, params, stats, inp


def jax_lbbdm_steps(cfg, jm, params, stats, inp):
    """The JAX step on a 2-device mesh over the ``MICROBATCHES`` global batches:
    (the JAX state after them, each batch's metrics, lr)."""
    training = dict2namespace({"accumulate_grad_batches": ACCUMULATE})
    tx = build_optimizer(cfg.BB.optimizer, trainable_mask=jm.trainable_mask(params))
    mesh = make_mesh(jax.devices()[:RANKS])
    jstate = replicate(mesh, JaxState(
        step=jnp.asarray(0, jnp.int32), params=params, ema_params=jax_ema_init(params),
        opt_state=tx.init(params), plateau=jax_plateau_init(cfg.BB.optimizer.lr),
        grad_accum=zeros_like_tree(params), latent_stats=stats))
    jstep = jax.jit(jax_make_train_step(jm, tx, training, dict2namespace(EMA),
                                        cfg.BB.lr_scheduler))
    metrics = []
    for x, y, key in zip(inp["x"], inp["y"], inp["key"]):
        jstate, m = jstep(jstate, shard_batch(mesh, x), shard_batch(mesh, y), key)
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    return jax.tree_util.tree_map(np.asarray, jstate), metrics, cfg.BB.optimizer.lr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario: the ranks in their own processes, the JAX step and the
    one-rank runs here meanwhile."""
    work = str(tmp_path_factory.mktemp("parallel"))
    write_pairs(os.path.join(work, "data"))
    write_images(os.path.join(work, "single"))
    lbbdm = lbbdm_inputs(work)
    ctx = mp.start_processes(worker.run, args=(RANKS, free_port(), work), nprocs=RANKS,
                             join=False, start_method="spawn")
    try:
        jax_out = jax_lbbdm_steps(*lbbdm)
        with one_thread():
            worker.vqgan_steps(0, 1, work)
            worker.vqgan_runner(0, 1, work)
            worker.sample_to_eval(0, 1, work)
    finally:
        join(ctx)
    return work, jax_out


def join(ctx, timeout=600):
    """Wait for the ranks; kill them and fail after ``timeout`` seconds (a rank
    that waits in a collective for one that left would wait for good)."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {timeout} s")


def load(work, name):
    return torch.load(os.path.join(work, name), weights_only=False)


# ---------------------------------------------------------------- loader

class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.full((2, 2, 1), i, np.float32)
        return (img, f"x{i}"), (-img, f"c{i}")


@pytest.mark.parametrize("n,nodes,local,batch,shuffle", [(10, 2, 2, 2, True),
                                                         (13, 3, 1, 2, True),
                                                         (9, 1, 4, 4, False),
                                                         (11, 2, 2, 4, False)])
def test_loader_shards_follow_the_jax_loader(n, nodes, local, batch, shuffle):
    """Node k's indices are the JAX loader's shard k (padding included); its
    ranks' rows, stacked, are its batches row for row."""
    ds = _Items(n)
    for node in range(nodes):
        want = JaxLoader(ds, batch, shuffle=shuffle, seed=7, shard_count=nodes,
                         shard_index=node, prefetch=0, num_workers=0)
        want.set_epoch(3)
        ranks = [DataLoader(ds, batch, shuffle=shuffle, seed=7, shard_count=nodes,
                            shard_index=node, local_count=local, local_index=r)
                 for r in range(local)]
        for loader in ranks:
            loader.set_epoch(3)
            np.testing.assert_array_equal(loader._indices(), want._indices())
            assert len(loader) == len(want)
        batches = list(want)
        assert batches
        for b, parts in zip(batches, zip(*ranks)):
            for key in ("x", "x_cond"):
                np.testing.assert_array_equal(np.concatenate([p[key] for p in parts]), b[key])
            assert sum((p["x_name"] for p in parts), []) == b["x_name"]


def test_loader_refuses_a_batch_the_ranks_do_not_split():
    with pytest.raises(ValueError, match="batch of 6 rows does not split over 4 ranks"):
        DataLoader(_Items(8), 6, local_count=4)


# --------------------------------------------------------------- training

def test_two_rank_lbbdm_update_matches_the_jax_mesh_step(runs):
    work, (jstate, metrics, lr) = runs
    got = load(work, "lbbdm_rank0_of2.pt")
    other = load(work, "lbbdm_rank1_of2.pt")
    for k, v in got["state_dict"].items():
        assert torch.equal(v, other["state_dict"][k]), k
    assert got["step"] == MICROBATCHES
    np.testing.assert_allclose(got["losses"], [float(m["loss"]) for m in metrics], atol=2e-4)
    assert got["lrs"] == other["lrs"] == [float(m["lr"]) for m in metrics]
    updates = MICROBATCHES // ACCUMULATE
    sd = got["state_dict"]
    assert_weights_close(jax_tree_from_state_dict(sd), jstate.params, lr, 2 * lr * updates)
    assert_weights_close(jax_tree_from_state_dict({**sd, **got["ema"]}), jstate.ema_params, lr,
                         2 * lr * updates)
    from flax import serialization

    assert_trees_close(got["opt_state"], serialization.to_state_dict(jstate.opt_state), 1e-4,
                       2e-4, "opt_state")
    want_p = serialization.to_state_dict(jstate.plateau)
    for k in ("lr", "num_bad", "cooldown_count"):
        assert got["plateau"][k] == want_p[k], k
    np.testing.assert_allclose(got["plateau"]["best"], want_p["best"], rtol=1e-4, atol=2e-4)


def test_two_rank_vqgan_step_matches_one_rank(runs):
    """Losses, d_weight, the discriminator's BatchNorm statistics (moved by the
    global batch's) and both players' weights."""
    work, _ = runs
    one, two = load(work, "vqgan_rank0_of1.pt"), load(work, "vqgan_rank0_of2.pt")
    other = load(work, "vqgan_rank1_of2.pt")
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
                         [one["state_dict"][k] for k in weights], worker.VQ_LR,
                         2 * worker.VQ_LR * worker.VQ_STEPS)
    for k, v in two["state_dict"].items():
        assert torch.equal(v, other["state_dict"][k]), k


def test_two_rank_vqgan_runner_matches_one_rank(runs):
    """``VQGANRunner`` through a step, a validation epoch (its loss the global
    batch's) and ``sample_to_eval`` (each rank its reconstructions): the
    validation loss 1e-5 relative, the weights with the bars above, the
    reconstructions within 1 uint8 code."""
    work, _ = runs
    one, two = load(work, "vq_rank0_of1.pt"), load(work, "vq_rank0_of2.pt")
    other = load(work, "vq_rank1_of2.pt")
    assert one["step"] == two["step"] == other["step"] == 1
    assert len(one["validations"]) == 1
    np.testing.assert_allclose(two["validations"], one["validations"], rtol=1e-5)
    assert two["validations"] == other["validations"]
    keys = [k for k in one["state_dict"] if not k.endswith((".mean", ".var"))]
    assert_weights_close([two["state_dict"][k] for k in keys],
                         [one["state_dict"][k] for k in keys], worker.VQ_LR, 2 * worker.VQ_LR)
    base = os.path.join("tiny", "tiny-vqgan", "sample_to_eval")
    a, b = (png_tree(os.path.join(work, f"vq_of{n}", base)) for n in (2, 1))
    assert sorted(a) == sorted(b) and len(b) == 2 * 4
    for k in b:
        assert np.abs(a[k].astype(int) - b[k]).max() <= 1, k


# --------------------------------------------------------------- sampling

def png_tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = read_png(os.path.join(d, n))
    return out


def test_two_rank_sample_to_eval_matches_one_rank(runs):
    work, _ = runs
    base = os.path.join("tiny", "tiny-lbbdm", "sample_to_eval")
    one = png_tree(os.path.join(work, "s2e_of1", base))
    two = png_tree(os.path.join(work, "s2e_of2", base))
    assert sorted(two) == sorted(one)
    assert {os.path.join("4", f"p{i}", f"output_{j}.png") for i in range(4) for j in range(2)} \
        <= set(one)
    for k in one:
        assert np.abs(two[k].astype(int) - one[k]).max() <= 1, k


# ------------------------------------------------------- stop and profile

def test_stop_file_on_rank_0_stops_every_rank_at_one_step(runs):
    """Rank 0's stop file, made during step 3, ends both ranks after step 3,
    after two epochs' validations (rank 1's SIGTERM during step 1 stopped
    nothing); rank 0 alone writes (its result tree with the graceful-stop
    checkpoint), and it removes the stop file."""
    work, _ = runs
    r0, r1 = load(work, "stop_rank0.pt"), load(work, "stop_rank1.pt")
    assert r0["global_step"] == r1["global_step"] == 3
    assert r0["stop_reason"].startswith("stop file")
    assert r1["stop_reason"] == "stop broadcast from rank 0"
    assert len(r0["validations"]) == 2 and r0["validations"] == r1["validations"]
    assert not r0["stop_file_left"]
    for k, v in r0["state_dict"].items():
        assert torch.equal(v, r1["state_dict"][k]), k
    ckpt = os.path.join(work, "train_rank0", "tiny", "tiny-lbbdm", "checkpoint")
    assert {"config.yaml", "last_model.ckpt", "last_optim_sche.ckpt"} <= set(os.listdir(ckpt))
    assert os.listdir(os.path.join(work, "train_rank0", "tiny", "tiny-lbbdm", "image")) == ["2"]
    assert not os.path.exists(os.path.join(work, "train_rank1"))


def test_profile_window_writes_a_trace_on_rank_0(runs):
    import json

    work, _ = runs
    prof = os.path.join(work, "prof_rank0")
    assert os.listdir(prof) == ["steps_2-2.pt.trace.json"]
    with open(os.path.join(prof, "steps_2-2.pt.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    assert not os.path.exists(os.path.join(work, "prof_rank1"))


def test_two_rank_device_cache_gathers_the_host_loaders_rows(runs):
    """Under ``training.device_data_cache`` each rank's cached train and val
    batches are its host loader's rows through ``_put_batch``, bit for bit;
    the two ranks' rows are the node's batch; the latent statistics gathered
    from the resident copies are the same on both ranks."""
    work, _ = runs
    ranks = [load(work, f"cache_rank{r}.pt") for r in range(RANKS)]
    for r in ranks:
        assert r["cached"] == [True, True] and r["equal"] and all(r["equal"])
        assert all(c == h for c, h in r["names"])
    for parts in zip(*(r["names"] for r in ranks)):
        rows = [names for names, _ in parts]
        assert len(set(sum(rows, []))) == sum(map(len, rows))  # each row on one rank
    for k in ranks[0]["latent_stats"]:
        assert torch.equal(ranks[0]["latent_stats"][k], ranks[1]["latent_stats"][k])
