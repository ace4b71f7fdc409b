"""The LBBDM-f8, LBBDM-f16 and cross-attention configurations in the port, on the CPU.

- Every template (and the f4 cross-attention variant ``chip_smoke.py`` drives)
  builds in the port on the meta device with the parameter names and shapes
  of the JAX package's ``jax.eval_shape`` of its init, after ``from_jax``'s
  renaming.
- The kernel calls ``chip_smoke.py`` derives its launch counts from (the
  port's modules walked on meta: every GroupNorm, every eval-mode up-conv,
  every attention the dispatch sends to K3) are the calls the JAX modules make
  at the same full-width shapes (``jax.eval_shape``, recorders in place of the
  three ops).
- Tiny f8-shaped (4-level VQGAN with attention at its lowest level, z 4,
  ``SpatialRescaler`` 3 stages) and f16-shaped (5 levels, z 8, 4 stages) LBBDMs,
  and a cross-attention one, sample as the JAX package does (fp32, the JAX
  draws fed in), within 2e-4 (``main_torch.py`` on the f8-shaped one:
  ``tests/test_torch_latent_cli.py``).
- ``normalize_latent`` statistics over the f8 and f16 latents' 4 and 8
  channels.
- K1's and K2's plans at the new paths' shapes (4^2 and 8^2 UNet levels) fit
  the card's limits as the LBBDM-f4 shapes do (``test_torch_kernel_plan.py``).
"""

import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_kernel_plan as plan_tests
import torch

import chip_smoke
import main_torch
from bbdm_tpu.config import dict2namespace as jax_namespace
from bbdm_tpu.config import load_config as jax_load
from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu_torch.checkpoints.from_jax import jax_tree_from_state_dict
from bbdm_tpu_torch.checkpoints.io import save_checkpoint
from bbdm_tpu_torch.config import apply_cli_overrides, dict2namespace, load_config, save_config
from bbdm_tpu_torch.data import DataLoader, get_dataset
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.ops.attention import KERNEL_MIN_SEQ
from bbdm_tpu_torch.runners.bbdm import BBDMRunner
from bbdm_tpu_torch.utils.images import write_png

ATOL = 2e-4
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def template(name, load):
    """A template's config tree by ``load`` (either package's reader); the
    ``-xattn`` variant is chip_smoke.py's phase-9 cut of Template-LBBDM-f4."""
    cfg = load(os.path.join(HERE, "configs", f"Template-{name.removesuffix('-xattn')}.yaml"))
    if name.endswith("-xattn"):
        u = cfg.model.BB.params.UNetParams
        u.use_spatial_transformer, u.transformer_depth, u.context_dim = True, 1, 3
        u.condition_key, u.in_channels = "SpatialRescaler", 6
    return cfg


def jax_init_shapes(cfg):
    if cfg.model.model_type == "VQGAN":
        from bbdm_tpu.runners.vqgan import _VQGANTrainModel

        model = _VQGANTrainModel(cfg.model)
    else:
        model = jax_build(cfg.model)
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    shapes.pop("disc_stats", None)  # BatchNorm statistics: buffers in the port
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("name", ["LBBDM-f4", "LBBDM-f8", "LBBDM-f16", "BBDM", "VQGAN-f4",
                                  "LBBDM-f4-xattn"])
def test_template_builds_the_jax_parameter_tree(name):
    from bbdm_tpu_torch.models.bridge import BrownianBridgeModel
    from bbdm_tpu_torch.models.latent import LatentBrownianBridgeModel
    from bbdm_tpu_torch.models.vqgan import VQGANTrainModel

    cfg = template(name, load_config)
    cls = {"BBDM": BrownianBridgeModel, "LBBDM": LatentBrownianBridgeModel,
           "VQGAN": VQGANTrainModel}[cfg.model.model_type]
    port = cls(cfg.model, device="meta")
    tree = jax_tree_from_state_dict({n: torch.empty(p.shape)
                                     for n, p in port.named_parameters()})
    got = {jax.tree_util.keystr(k): tuple(v.shape)
           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == jax_init_shapes(template(name, jax_load))


def jax_kernel_calls(cfg, batch):
    """The JAX modules' calls of the three ops, as ``chip_smoke.kernel_calls``
    counts the port's: ``jax.eval_shape`` of the UNet's and the VQGAN's (none
    for a pixel BBDM) init
    (one forward each, in eval mode) with recorders in the modules' namespaces;
    shapes NCHW as the port's. K3 the attentions the JAX dispatch sends to its
    kernel; every other attention under ``"attn"``, (B, H, Tq, D, Tk, bf16)."""
    from bbdm_tpu.models import layers as jl
    from bbdm_tpu.models import vqgan as jv

    seen = Counter()

    def k1(x, *a, **kw):
        seen["K1", (x.shape[0], x.shape[-1], *x.shape[1:-1])] += 1
        return jnp.zeros_like(x)

    def k2(x, kernel, bias, *, dtype=None, combined=None):
        N, h, w, ci = x.shape
        co = kernel.shape[-1]
        seen["K2", (N, ci, h, w, co)] += 1
        return jnp.zeros((N, 2 * h, 2 * w, co), dtype or jnp.result_type(x, kernel))

    def k3(q, k, v, **kw):
        shape = (*q.shape, k.shape[-2])
        if q.shape[-2] >= KERNEL_MIN_SEQ and q.shape[-1] % 128 == 0:  # the JAX rule
            seen["K3", shape] += 1
        else:
            seen["attn", (*shape, q.dtype == jnp.bfloat16)] += 1
        return jnp.zeros_like(q)

    model = jax_build(cfg.model)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        mp.setattr(jl, "group_norm", k1)
        mp.setattr(jl, "upsample2x_conv3x3", k2)
        mp.setattr(jl, "multi_head_attention", k3)
        mp.setattr(jv, "multi_head_attention", k3)
        x, t, ctx = model._unet_init_args()
        x = jnp.zeros((batch, *x.shape[1:]))
        ctx = None if ctx is None else jnp.zeros((batch, *ctx.shape[1:]))
        jax.eval_shape(lambda r: model.unet.init(r, x, jnp.zeros((batch,), jnp.int32), ctx),
                       jax.random.PRNGKey(0))
        out["unet"], seen = seen, Counter()
        if cfg.model.model_type == "LBBDM":  # a pixel BBDM has no first stage
            res = cfg.model.VQGAN.params.ddconfig.resolution
            jax.eval_shape(lambda r: model.vqgan.init(r, jnp.zeros((batch, res, res, 3))),
                           jax.random.PRNGKey(0))
        out["vqgan"] = seen
    finally:
        mp.undo()
    return out


def under_cuda_rule(calls):
    """:func:`jax_kernel_calls`' counts of one part as the port's CUDA dispatch
    makes them: the JAX rule's K3 calls, plus its one departure from that rule,
    K3 also taking bf16 heads of 8..256 over at least 2^20 scores."""
    out = Counter({key: n for key, n in calls.items() if key[0] != "attn"})
    out.update({("K3", s[:-1]): n for (kind, s), n in calls.items()
                if kind == "attn" and s[-1] and s[2] * s[4] >= 2 ** 20 and s[3] % 8 == 0
                and s[3] <= 256})
    return out


@pytest.mark.parametrize("name", ["LBBDM-f8", "LBBDM-f16", "LBBDM-f4-xattn"])
def test_smoke_launch_counts_come_from_the_jax_modules_calls(name):
    want = jax_kernel_calls(template(name, jax_load), 8)
    got = chip_smoke.kernel_calls(chip_smoke.path_configs()[name].model, 8)

    def k3(calls):
        return Counter({key: n for key, n in calls.items() if key[0] == "K3"})

    for port, jax_calls in ((got["unet"], want["unet"]),
                            (got["encoder"] + got["decoder"], want["vqgan"])):
        assert k3(jax_calls) - k3(port) == Counter()
        assert k3(port) - k3(jax_calls) == k3(under_cuda_rule(jax_calls)) - k3(jax_calls)
        assert port == under_cuda_rule(jax_calls)
    # training mode: every norm and attention as in eval, no up-conv kernel
    assert got["unet_train"] == Counter({k: n for k, n in under_cuda_rule(want["unet"]).items()
                                         if k[0] != "K2"})
    if name == "LBBDM-f4-xattn":  # its middle cross-attention, 256 x 4096 at D 64
        assert k3(got["unet"]) - k3(want["unet"]) == Counter({("K3", (8, 16, 256, 64, 4096)): 1})


# ------------------------------------------------------- tiny latent paths

def tiny(shape):
    """A tiny LBBDM of one of the new paths' shapes: ``f8`` a 4-level VQGAN
    (attention at its lowest level, z 4) with a 3-stage SpatialRescaler
    context; ``f16`` 5 levels (z 8), 4 stages; ``xattn`` the f4 VQGAN with a
    cross-attention UNet over the SpatialRescaler context. fp32, 32^2 images
    (f16: 64^2, so that the UNet's lowest level is 2^2: at 1^2 with two
    channels per group each GroupNorm divides by the spread of two values and
    multiplies rounding differences ~10x a block, in either package)."""
    levels, attn, z, stages, xattn, res = {
        "f8": ((1, 2, 2, 4), [4], 4, 3, False, 32),
        "f16": ((1, 1, 2, 2, 4), [4], 8, 4, False, 64),
        "xattn": ((1, 2, 4), [], 3, 2, True, 32)}[shape]
    lat = res // 2 ** (len(levels) - 1)
    return {
        "model_name": f"tiny-{shape}", "model_type": "LBBDM",
        "latent_before_quant_conv": False, "normalize_latent": False,
        "only_load_latent_mean_std": False, "mixed_precision": False,
        "CondStageParams": {"n_stages": stages, "in_channels": 3, "out_channels": z},
        "VQGAN": {"params": {
            "ckpt_path": None, "embed_dim": z, "n_embed": 32,
            "ddconfig": {"double_z": False, "z_channels": z, "resolution": res, "in_channels": 3,
                         "out_ch": 3, "ch": 32, "ch_mult": levels, "num_res_blocks": 1,
                         "attn_resolutions": attn, "dropout": 0.0}}},
        "BB": {
            "optimizer": {"weight_decay": 0.0, "optimizer": "Adam", "lr": 1e-3, "beta1": 0.9},
            "lr_scheduler": {"factor": 0.5, "patience": 10, "threshold": 1e-4, "cooldown": 10,
                             "min_lr": 1e-7},
            "params": {
                "mt_type": "linear", "objective": "grad", "loss_type": "l1",
                "skip_sample": True, "sample_type": "linear", "sample_step": 4,
                "num_timesteps": 20, "eta": 1.0, "max_var": 1.0,
                "UNetParams": {
                    "image_size": lat, "in_channels": 2 * z, "model_channels": 32,
                    "out_channels": z, "num_res_blocks": 1, "attention_resolutions": (2,),
                    "channel_mult": (1, 2), "conv_resample": True, "dims": 2, "num_heads": 4,
                    "num_head_channels": 8, "use_scale_shift_norm": True,
                    "resblock_updown": True, "use_spatial_transformer": xattn,
                    "transformer_depth": 1, "context_dim": z if xattn else None,
                    "condition_key": "SpatialRescaler"}}}}


def seeded(cfg_dict, seed):
    """The port's model with seeded weights (each perturbed) and its JAX tree."""
    port = port_build(jax_namespace(cfg_dict), device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return port, jax_tree_from_state_dict(port)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape", ["f8", "f16", "xattn"])
def test_tiny_latent_sample_matches_jax(shape):
    """LBBDM.sample (encode, context, 4 euler steps with eta 1, decode) against
    the JAX model with the JAX draws fed in; also the latent and context."""
    d = tiny(shape)
    jm = jax_build(jax_namespace(d))
    port, params = seeded(d, 3)
    res = d["VQGAN"]["params"]["ddconfig"]["resolution"]
    x_cond = np.random.RandomState(7).uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    img = jax.jit(lambda p, r, x: jm.sample(p, r, x, clip_denoised=False))(params, key, x_cond)
    y = jax.jit(lambda p, x: jm.encode(p, x, cond=True))(params, x_cond)
    ctx = jax.jit(jm.get_cond_stage_context)(params, x_cond)
    draws, k = [], key
    for _ in range(port.noised_steps()):
        k, step_key = jax.random.split(k)
        draws.append(nchw(jax.random.normal(step_key, y.shape, jnp.float32)))
    assert port.encode(nchw(x_cond)).shape[1:] == nchw(y).shape[1:]
    np.testing.assert_allclose(port.get_cond_stage_context(nchw(x_cond)).detach().numpy(),
                               nchw(ctx).numpy(), rtol=1e-5, atol=1e-5)
    out = port.sample(nchw(x_cond), noise=draws)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(img), rtol=1e-4,
                               atol=ATOL)


@pytest.mark.parametrize("shape,channels", [("f8", 4), ("f16", 8)])
def test_latent_statistics_over_the_new_latent_channels(tmp_path, shape, channels):
    """``normalize_latent`` with the f8- and f16-shaped latents: the runner's
    two-pass statistics are [1, C, 1, 1] for C = 4 and 8, and equal the mean
    of per-batch means (then of per-batch squared deviations) of its own
    encodes, batch by batch in the loader's order (the formula itself is held
    against the JAX runner in ``tests/test_torch_train_runner.py``)."""
    d = tiny(shape)
    res = d["VQGAN"]["params"]["ddconfig"]["resolution"]
    rs = np.random.RandomState(1)
    for stage, n in (("train", 4), ("val", 2), ("test", 2)):
        for side in "AB":
            os.makedirs(tmp_path / "data" / stage / side)
            for i in range(n):
                write_png(str(tmp_path / "data" / stage / side / f"p{i}.png"),
                          rs.randint(0, 256, (res, res, 3)).astype(np.uint8))
    _, params = seeded(d, 7)
    save_checkpoint({"vqgan": params["vqgan"]}, str(tmp_path / "vq.ckpt"))
    d.update(normalize_latent=True, EMA={"use_ema": False})
    d["VQGAN"]["params"]["ckpt_path"] = str(tmp_path / "vq.ckpt")
    cfg = {"runner": "BBDMRunner",
           "training": {"n_epochs": 1, "n_steps": 10, "save_interval": 1, "sample_interval": 1,
                        "validation_interval": 1, "accumulate_grad_batches": 1},
           "testing": {"clip_denoised": False, "sample_num": 1},
           "data": {"dataset_name": "tiny", "dataset_type": "custom_aligned",
                    "dataset_config": {"dataset_path": str(tmp_path / "data"),
                                       "image_size": res, "channels": 3, "to_normal": True,
                                       "flip": False},
                    "train": {"batch_size": 2, "shuffle": True},
                    "val": {"batch_size": 2, "shuffle": True}, "test": {"batch_size": 2}},
           "model": d}
    save_config(dict2namespace(cfg), str(tmp_path / "c.yaml"))
    argv = ["-c", str(tmp_path / "c.yaml"), "--train", "--gpu_ids", "-1", "-r",
            str(tmp_path / "out")]
    runner = BBDMRunner(apply_cli_overrides(load_config(str(tmp_path / "c.yaml")),
                                            main_torch.parse_args(argv)))
    stats = runner.latent_stats
    assert {k: tuple(v.shape) for k, v in stats.items()} == {
        k: (1, channels, 1, 1) for k in stats}
    loader = DataLoader(get_dataset(runner.config.data)[0], 2, shuffle=True,
                        seed=runner.config.args.seed)
    zs = [(runner.model.encode(x, cond=False, normalize=False),
           runner.model.encode(y, cond=True, normalize=False))
          for x, y in (runner._put_batch(b) for b in loader)]
    mean = lambda t: t.mean(dim=(0, 2, 3), keepdim=True)
    for i, pre in enumerate(("ori", "cond")):
        m = sum(mean(z[i]) for z in zs) / len(zs)
        sd = torch.sqrt(sum(mean((z[i] - m) ** 2) for z in zs) / len(zs))
        torch.testing.assert_close(stats[f"{pre}_latent_mean"], m, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(stats[f"{pre}_latent_std"], sd, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------- kernel plans, new shapes

# (N, ci, co, h, w) of the f8 and f16 UNets' and decoders' up-convs that the
# LBBDM-f4 path does not give (chip_smoke.kernel_calls at batch 8)
NEW_UPCONV = [(8, 1024, 1024, 4, 4), (8, 512, 512, 8, 8), (8, 1024, 1024, 8, 8),
              (8, 512, 512, 16, 16), (8, 256, 256, 64, 64), (8, 256, 256, 32, 32),
              (8, 128, 128, 128, 128)]
# (N, C, H, W, itemsize) of the new paths' smallest GroupNorms
NEW_GN = [(8, 1024, 4, 4, 2), (8, 2048, 4, 4, 2), (8, 512, 4, 4, 2), (8, 1024, 16, 16, 2)]


UPCONV_CHECKS = [plan_tests.test_upconv_boxes_fit_their_tensors,
                 plan_tests.test_upconv_tiles_cover_each_output_pixel_once,
                 plan_tests.test_upconv_f32_plan_fits_tma_and_covers_each_pixel_once]


@pytest.mark.parametrize("check", UPCONV_CHECKS)
@pytest.mark.parametrize("shape", NEW_UPCONV)
def test_upconv_plan_at_the_new_paths_shapes(check, shape):
    check(shape)


def test_new_upconv_shapes_are_the_paths():
    got = set()
    for cfg in chip_smoke.path_configs().values():
        for part in chip_smoke.kernel_calls(cfg.model, 8).values():
            got |= {s for k, s in part if k == "K2"}
    new = {(n, ci, h, w, co) for n, ci, co, h, w in NEW_UPCONV}
    old = {(n, ci, h, w, co) for n, ci, co, h, w in plan_tests.UPCONV_SHAPES}
    assert new <= got and got <= new | old


@pytest.mark.parametrize("check", [plan_tests.test_group_norm_plan_fits_the_card,
                                   plan_tests.test_group_norm_slices_tile_each_span_once,
                                   plan_tests.test_group_norm_bulk_copies_are_16_byte_aligned])
@pytest.mark.parametrize("shape", NEW_GN)
def test_group_norm_plan_at_the_new_shapes(check, shape):
    check(shape)



def test_group_norm_backward_plan_at_every_training_shape_of_the_paths():
    """K1's backward runs at each UNet GroupNorm of a training microbatch: its
    plan checks at those of the f8, f16 and f4-xattn paths (bf16)."""
    checks = (plan_tests.test_group_norm_bwd_plan_holds_x_and_dy,
              plan_tests.test_group_norm_bwd_slices_tile_each_span_once,
              plan_tests.test_group_norm_bwd_warp_entries_and_partials_do_not_collide)
    shapes = set()
    for cfg in chip_smoke.path_configs().values():
        shapes |= {s for k, s in chip_smoke.kernel_calls(cfg.model, 8)["unet_train"] if k == "K1"}
    assert shapes - set(plan_tests.GN_TRAIN_SHAPES)  # the paths reach shapes f4's does not
    for shape in sorted(shapes):
        for check in checks:
            check((*shape, 2))
