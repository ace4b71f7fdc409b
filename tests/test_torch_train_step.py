"""Four train steps of the port (``training/step.py``) against the JAX package's
``make_train_step``, on the CPU.

Both start from the JAX package's initial weights (tiny pixel BBDM of
tests/conftest.py; tiny LBBDM with a SpatialRescaler of tests/test_latent.py,
with latent statistics), get the same numpy batches and, through ``t=`` /
``noise=``, the draws the JAX step takes from its key. After every step the
test compares the parameters, the EMA, the optimizer state (through
``checkpoints/from_jax.opt_state_to_jax``, which must give the tree flax's
``to_state_dict`` gives, ``{}`` at masked leaves included) and the plateau
state. Cases: Adam and RMSProp with weight decay, SGD, Adam with
``accumulate_grad_batches`` 2; every case crosses the EMA warm-up boundary
(``start_ema_step`` 2) and a plateau of patience 1 whose threshold makes the
third update's loss "bad" twice and so halves the lr.

Bars (fp32; the gradients already differ by summation order, see
test_torch_train_loss.py): parameters and EMA within a tenth of the largest
update one step can make (lr; 10 lr for RMSProp's first steps) but for at most
one element in 10^4, which stays within two such updates per step taken
(``assert_weights_close`` says why); moments and the plateau's best within
2e-4 absolute plus 1e-4 relative; the step counters, the Adam count and the
plateau's counters and lr exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from test_latent import lbbdm_config

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu.training.ema import ema_init as jax_ema_init
from bbdm_tpu.training.optim import build_optimizer
from bbdm_tpu.training.plateau import plateau_init as jax_plateau_init
from bbdm_tpu.training.state import TrainState as JaxState
from bbdm_tpu.training.state import zeros_like_tree
from bbdm_tpu.training.step import make_train_step as jax_make_train_step
from bbdm_tpu_torch.checkpoints.from_jax import (
    LATENT_STATS,
    jax_tree_from_state_dict,
    latent_stats_from_jax,
    opt_state_to_jax,
    plateau_to_jax,
    state_dict_from_jax,
)
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.training.ema import ema_init
from bbdm_tpu_torch.training.optim import Optimizer
from bbdm_tpu_torch.training.plateau import plateau_init
from bbdm_tpu_torch.training.state import TrainState
from bbdm_tpu_torch.training.step import make_train_step
from tests.conftest import tiny_bbdm_config

STEPS = 4
EMA = {"use_ema": True, "ema_decay": 0.9, "update_ema_interval": 1, "start_ema_step": 2}
SCHED = {"factor": 0.5, "patience": 1, "threshold": 0.5, "cooldown": 0, "min_lr": 1e-7}
CASES = {
    "adam-wd": ("bbdm", {"optimizer": "Adam", "weight_decay": 0.01}, 1),
    "rmsprop-wd": ("bbdm", {"optimizer": "RMSProp", "weight_decay": 0.01}, 1),
    "sgd": ("bbdm", {"optimizer": "SGD"}, 1),
    "adam-acc2": ("bbdm", {"optimizer": "Adam"}, 2),
    "lbbdm-sr-adam": ("lbbdm", {"optimizer": "Adam"}, 1),
}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def model_config(kind, optim):
    cfg = tiny_bbdm_config() if kind == "bbdm" else lbbdm_config("SpatialRescaler",
                                                                 normalize_latent=True)
    # two channels per GroupNorm group: at one, a conv bias in front of a norm
    # has a gradient of exactly zero in exact arithmetic, and Adam's g / (|g| +
    # eps) turns each side's rounding noise there into an update of ~lr / 10
    cfg.BB.params.UNetParams.model_channels = 64
    cfg.BB.optimizer.lr = 1e-4
    for k, v in optim.items():
        cfg.BB.optimizer[k] = v
    cfg.BB.lr_scheduler = dict2namespace(SCHED)
    return cfg


@pytest.fixture(scope="module")
def init():
    out = {}
    for kind in ("bbdm", "lbbdm"):
        m = jax_build(model_config(kind, {}))
        out[kind] = jax.tree_util.tree_map(np.asarray,
                                           jax.jit(m.init_params)(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(1)
    out["stats"] = {k: rs.uniform(0.5, 1.5, (1, 1, 1, 3)).astype(np.float32)
                    for k in LATENT_STATS}
    return out


def assert_weights_close(got, want, step, bound):
    """Parameters (or EMA) of the two runs: every element within a tenth of
    one ``step`` (the largest update a step can make) of the JAX value but
    for at most one in 10^4, and those within ``bound``. Adam and RMSProp
    divide by sqrt(nu) + 1e-8, so where a gradient cancels to near zero
    (|g| ~ 1e-8) its rounding noise, different in the two frameworks, becomes a
    step of up to a full update either way."""
    g = jax.tree_util.tree_flatten(got)[0]
    w = jax.tree_util.tree_flatten(want)[0]
    assert len(g) == len(w)
    d = np.concatenate([np.abs(np.asarray(a) - np.asarray(b)).ravel() for a, b in zip(g, w)])
    far = d > step / 10
    assert far.mean() <= 1e-4 and d.max() <= bound, (int(far.sum()), d.max())


def assert_trees_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_close(got[k], want[k], rtol, atol, f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_make_train_step(init, case):
    kind, optim, accumulate = CASES[case]
    cfg = model_config(kind, optim)
    training = dict2namespace({"accumulate_grad_batches": accumulate})
    ema_cfg, sched = dict2namespace(EMA), cfg.BB.lr_scheduler
    params = init[kind]
    stats = init["stats"] if kind == "lbbdm" else None

    jm = jax_build(cfg)
    tx = build_optimizer(cfg.BB.optimizer, trainable_mask=jm.trainable_mask(params))
    jstate = JaxState(step=jnp.asarray(0, jnp.int32), params=params,
                      ema_params=jax_ema_init(params), opt_state=tx.init(params),
                      plateau=jax_plateau_init(cfg.BB.optimizer.lr),
                      grad_accum=zeros_like_tree(params) if accumulate > 1 else None,
                      latent_stats=stats)
    jstep = jax.jit(jax_make_train_step(jm, tx, training, ema_cfg, sched))

    port = port_build(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, port))
    port.train()
    trainable = port.trainable_parameters()
    state = TrainState(step=0, params=trainable, ema=ema_init(trainable),
                       optimizer=Optimizer(cfg.BB.optimizer, trainable),
                       plateau=plateau_init(cfg.BB.optimizer.lr),
                       latent_stats=latent_stats_from_jax(stats) if stats else None)
    step = make_train_step(port, training, ema_cfg, sched)

    size = 8 if kind == "bbdm" else 16
    rs = np.random.RandomState(2)
    lrs = []
    for i in range(STEPS):
        x = rs.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        y = np.clip(-x + rs.uniform(-0.3, 0.3, x.shape), -1, 1).astype(np.float32)
        key = jax.random.PRNGKey(10 + i)
        jstate, metrics = jstep(jstate, x, y, key)
        # the draws of BrownianBridgeModel.loss, at the latent's shape for the LBBDM
        t_rng, n_rng = jax.random.split(key)
        shape = x.shape if kind == "bbdm" else jax.eval_shape(
            lambda p, x: jm.encode(p, x), params, x).shape
        t = torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, jm.num_timesteps)))
        noise = nchw(jax.random.normal(n_rng, shape))
        out = step(state, nchw(x), nchw(y), t=t, noise=noise)

        assert state.step == int(jstate.step) == i + 1
        assert abs(float(out["loss"]) - float(metrics["loss"])) <= 2e-4
        sd = port.state_dict()
        # RMSProp's first steps divide by sqrt(0.01 g^2): up to 10 lr each
        step_max = cfg.BB.optimizer.lr * (10 if optim["optimizer"] == "RMSProp" else 1)
        for got, want in ((jax_tree_from_state_dict(sd), jstate.params),
                          (jax_tree_from_state_dict({**sd, **state.ema}), jstate.ema_params)):
            assert_weights_close(got, want, step_max, 2 * step_max * (i + 1))
        want_opt = jax.tree_util.tree_map(np.asarray,
                                          serialization.to_state_dict(jstate.opt_state))
        assert_trees_close(opt_state_to_jax(state.optimizer, port), want_opt, 1e-4, 2e-4,
                           "opt_state")
        got_p = plateau_to_jax(state.plateau)
        want_p = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate.plateau))
        for k in ("lr", "num_bad", "cooldown_count"):
            assert got_p[k] == want_p[k] and got_p[k].dtype == want_p[k].dtype, k
        np.testing.assert_allclose(got_p["best"], want_p["best"], rtol=1e-4, atol=2e-4)
        lrs.append(float(got_p["lr"]))
    if accumulate == 1:  # the third update's loss is the second "bad" one: lr halves
        assert lrs[2] == lrs[0] / 2
