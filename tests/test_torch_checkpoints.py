"""The port's checkpoint I/O against the JAX package: ``.ckpt`` files both ways,
reference ``.pth`` files through both converters, and which weights a runner
samples with."""

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from test_latent import lbbdm_config
from test_torch_import import _vqgan_torch_keys, build_synthetic_unet_sd

from bbdm_tpu.checkpoints import io as jax_io
from bbdm_tpu.checkpoints.torch_import import convert_reference_checkpoint as jax_convert
from bbdm_tpu.config import dict2namespace
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu_torch.checkpoints import io
from bbdm_tpu_torch.checkpoints.from_jax import (
    LATENT_STATS,
    jax_tree_from_state_dict,
    latent_stats_from_jax,
    latent_stats_to_jax,
    load_model_checkpoint,
    state_dict_from_jax,
)
from bbdm_tpu_torch.checkpoints.torch_import import convert_reference_checkpoint
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.runners.bbdm import BBDMRunner
from tests.conftest import tiny_bbdm_config


def init_tree(cfg, seed):
    m = jax_build(cfg)
    return jax.tree_util.tree_map(np.asarray, jax.jit(m.init_params)(jax.random.PRNGKey(seed)))


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), path


@pytest.fixture(scope="module")
def trees():
    """JAX-initialised trees: tiny BBDM, tiny LBBDM (model and a different
    ema), LBBDM with a SpatialRescaler condition stage."""
    lb = lbbdm_config()
    sr = lbbdm_config("SpatialRescaler")
    return {"bbdm": init_tree(tiny_bbdm_config(), 0), "lbbdm": init_tree(lb, 0),
            "lbbdm_ema": init_tree(lb, 1), "sr": init_tree(sr, 0), "sr_ema": init_tree(sr, 1)}


def lbbdm_states(trees):
    rs = np.random.RandomState(0)
    stats = {k: rs.uniform(0.5, 1.5, (1, 1, 1, 3)).astype(np.float32) for k in LATENT_STATS}
    return {"model": trees["lbbdm"], "ema": trees["lbbdm_ema"], "step": 1234, "epoch": 7,
            **stats}


@pytest.mark.parametrize("kind", ["bbdm", "lbbdm"])
def test_jax_ckpt_loads_in_the_port_leaf_for_leaf(tmp_path, trees, kind):
    states = ({"model": trees["bbdm"], "step": 3, "epoch": 1} if kind == "bbdm"
              else lbbdm_states(trees))
    path = str(tmp_path / "m.ckpt")
    jax_io.save_checkpoint(states, path)
    assert_trees_equal(io.load_checkpoint(path), jax_io.load_checkpoint(path))


@pytest.mark.parametrize("kind", ["bbdm", "lbbdm"])
def test_port_ckpt_loads_in_jax_leaf_for_leaf(tmp_path, trees, kind):
    states = ({"model": trees["bbdm"], "step": 3, "epoch": 1} if kind == "bbdm"
              else lbbdm_states(trees))
    path = str(tmp_path / "m.ckpt")
    io.save_checkpoint(states, path)
    assert_trees_equal(jax_io.load_checkpoint(path), states)
    # and the bytes are flax's own
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(io._sorted(states))


def test_msgpack_widths_scalars_and_chunks_match_flax(monkeypatch):
    """Every integer, string, map and array width, numpy scalars, bfloat16 and
    arrays split into chunks (chunk size cut to 64 bytes on both sides)."""
    import jax.numpy as jnp

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(io, "_CHUNK_BYTES", 64)
    rs = np.random.RandomState(0)
    tree = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
                     -32768, -32769, -2 ** 31 - 1],
            "s": ["", "x" * 31, "y" * 32, "z" * 256, "ü" * 40000],
            "f": [0.5, -1e300], "b": [True, False, None],
            "big_map": {str(i): i for i in range(70000)},
            "scalar": np.float32(2.5), "i64": np.int64(-7),
            "chunked": rs.randn(7, 5).astype(np.float32), "empty": np.zeros((0, 3), np.int32),
            "u8": np.arange(300, dtype=np.uint8).reshape(3, 100)}
    data = b"".join(bytes(p) for p in io.msgpack_serialize(tree))
    assert data == serialization.msgpack_serialize(io._sorted(tree))
    assert_trees_equal(io.msgpack_restore(data), serialization.msgpack_restore(data))
    bf = {"w": np.asarray(jnp.asarray(rs.randn(4, 3), jnp.bfloat16))}
    out = io.msgpack_restore(serialization.msgpack_serialize(bf))["w"]
    np.testing.assert_array_equal(out, bf["w"].astype(np.float32))


def test_truncated_checkpoint_raises(tmp_path, trees):
    path = str(tmp_path / "m.ckpt")
    io.save_checkpoint({"model": trees["bbdm"], "step": 0, "epoch": 0}, path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-100])
    with pytest.raises(io.CheckpointFormatError, match="m.ckpt: truncated"):
        io.load_checkpoint(path)


@pytest.mark.parametrize("kind", ["bbdm", "sr"])
def test_state_dict_round_trips_through_the_jax_tree(trees, kind):
    cfg = tiny_bbdm_config() if kind == "bbdm" else lbbdm_config("SpatialRescaler")
    model = port_build(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(trees[kind], model))
    assert_trees_equal(jax_tree_from_state_dict(model), trees[kind])


def test_latent_stats_layouts():
    rs = np.random.RandomState(1)
    states = {k: rs.randn(1, 1, 1, 4).astype(np.float32) for k in LATENT_STATS}
    stats = latent_stats_from_jax(states)
    assert stats["ori_latent_mean"].shape == (1, 4, 1, 1)
    np.testing.assert_array_equal(stats["cond_latent_std"].numpy().ravel(),
                                  states["cond_latent_std"].ravel())
    assert_trees_equal(latent_stats_to_jax(stats), states)


def write_reference_pth(path, cfg, model_tree, ema_tree, seed):
    """A reference-repo training checkpoint: the UNet under ``denoise_fn.``, the
    VQGAN under ``vqgan.``, the SpatialRescaler under ``cond_stage_model.``; the
    EMA shadow holds the trainable parts only; latent stats NCHW."""
    def sd(tree, s):
        out = build_synthetic_unet_sd(cfg.BB.params.UNetParams, tree["unet"])
        rs = np.random.RandomState(s)
        out = {k: rs.randn(*v.shape).astype(np.float32) for k, v in out.items()}
        out["cond_stage_model.channel_mapper.weight"] = rs.randn(3, 3, 1, 1).astype(np.float32)
        return out

    model_sd = sd(model_tree, seed)
    vq = cfg.VQGAN.params.ddconfig
    model_sd.update({f"vqgan.{k}": v for k, v in _vqgan_torch_keys(
        vq.ch, vq.ch_mult, vq.num_res_blocks, vq.z_channels, cfg.VQGAN.params.embed_dim,
        cfg.VQGAN.params.n_embed, vq.resolution).items() if not k.startswith("loss.")})
    ema_sd = sd(ema_tree, seed + 1)
    rs = np.random.RandomState(seed + 2)
    raw = {"model": {k: torch.from_numpy(v) for k, v in model_sd.items()},
           "ema": {k: torch.from_numpy(v) for k, v in ema_sd.items()},
           "step": 11, "epoch": 2,
           **{k: torch.from_numpy(rs.uniform(0.5, 1.5, (1, 3, 1, 1)).astype(np.float32))
              for k in LATENT_STATS}}
    torch.save(raw, path)


@pytest.mark.parametrize("use_ema", [True, False])
def test_reference_pth_loads_as_through_the_jax_converter(tmp_path, trees, use_ema):
    cfg = lbbdm_config("SpatialRescaler")
    path = str(tmp_path / "ref.pth")
    write_reference_pth(path, cfg, trees["sr"], trees["sr_ema"], seed=5)
    mine, ref = convert_reference_checkpoint(path, cfg), jax_convert(path, cfg)
    assert_trees_equal(mine, ref)
    a, b = port_build(cfg, device="cpu"), port_build(cfg, device="cpu")
    assert load_model_checkpoint(mine, a, use_ema) == (2, 11)
    b.load_state_dict(state_dict_from_jax(ref["ema" if use_ema else "model"], b))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)


def runner_config(model_cfg, **model_over):
    d = {"model": model_cfg.to_dict(), "testing": {"sample_num": 1, "clip_denoised": False},
         "data": {"dataset_config": {"to_normal": True}}}
    d["model"].update(model_over)
    return dict2namespace(d)


@pytest.mark.parametrize("use_ema", [True, False])
def test_runner_samples_with_ema_exactly_when_use_ema(tmp_path, trees, use_ema):
    """model and ema differ: the runner's weights, and so its samples, are the
    ema tree's when EMA.use_ema holds and the model tree's otherwise."""
    cfg = lbbdm_config()
    cfg.BB.params.eta = 0.0
    path = str(tmp_path / "m.ckpt")
    jax_io.save_checkpoint(lbbdm_states(trees), path)
    runner = BBDMRunner(runner_config(cfg, EMA={"use_ema": use_ema}, model_load_path=path),
                        device="cpu", seed=0)
    assert (runner.global_epoch, runner.global_step) == (7, 1234)
    chosen, other = ("lbbdm_ema", "lbbdm") if use_ema else ("lbbdm", "lbbdm_ema")
    assert_trees_equal(jax_tree_from_state_dict(runner.model), trees[chosen])

    x = np.random.RandomState(3).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    out = runner.sample_batch(x)
    for name, same in ((chosen, True), (other, False)):
        m = port_build(cfg, device="cpu")
        m.load_state_dict(state_dict_from_jax(trees[name], m))
        ref = m.sample(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert np.array_equal(out[0], ref) == same


@pytest.mark.parametrize("only_stats", [False, True])
def test_runner_reads_latent_stats(tmp_path, trees, only_stats):
    cfg = lbbdm_config()
    path = str(tmp_path / "m.ckpt")
    states = lbbdm_states(trees)
    jax_io.save_checkpoint(states, path)
    runner = BBDMRunner(runner_config(cfg, normalize_latent=True, model_load_path=path,
                                      only_load_latent_mean_std=only_stats,
                                      EMA={"use_ema": True}), device="cpu", seed=0)
    assert_trees_equal(latent_stats_to_jax(runner.latent_stats),
                       {k: states[k] for k in LATENT_STATS})
    loaded = jax_tree_from_state_dict(runner.model)["unet"]["stem"]["kernel"]
    assert np.array_equal(loaded, trees["lbbdm_ema"]["unet"]["stem"]["kernel"]) != only_stats


@pytest.mark.parametrize("fmt", ["jax", "ldm"])
def test_runner_loads_the_frozen_vqgan(tmp_path, trees, fmt):
    cfg = lbbdm_config()
    if fmt == "jax":
        path = str(tmp_path / "vq.ckpt")
        jax_io.save_checkpoint({"vqgan": trees["lbbdm_ema"]["vqgan"]}, path)
        expect = trees["lbbdm_ema"]["vqgan"]
    else:
        from bbdm_tpu.checkpoints.torch_import import convert_ldm_vqgan_checkpoint

        path = str(tmp_path / "vq.pth")
        vq = cfg.VQGAN.params.ddconfig
        sd = _vqgan_torch_keys(vq.ch, vq.ch_mult, vq.num_res_blocks, vq.z_channels,
                               cfg.VQGAN.params.embed_dim, cfg.VQGAN.params.n_embed,
                               vq.resolution)
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
        expect = convert_ldm_vqgan_checkpoint(path)
    cfg.VQGAN.params.ckpt_path = path
    runner = BBDMRunner(runner_config(cfg), device="cpu", seed=0)
    assert_trees_equal(jax_tree_from_state_dict(runner.model.vqgan), expect)


def test_missing_vqgan_checkpoint_raises(tmp_path):
    cfg = lbbdm_config()
    cfg.VQGAN.params.ckpt_path = str(tmp_path / "absent.ckpt")
    with pytest.raises(FileNotFoundError, match="absent.ckpt"):
        BBDMRunner(runner_config(cfg), device="cpu", seed=0)


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A write that fails leaves the previous file as it was."""
    path = str(tmp_path / "m.ckpt")
    io.save_checkpoint({"v": np.ones(3, np.float32)}, path)

    def broken(tree):
        return [b"\x81", object()]  # fails on the second write

    monkeypatch.setattr(io, "msgpack_serialize", broken)
    with pytest.raises(TypeError):
        io.save_checkpoint({"v": np.zeros(3, np.float32)}, path)
    np.testing.assert_array_equal(io.load_checkpoint(path)["v"], np.ones(3, np.float32))
