"""The port's cross-attention family and embedders against the JAX package, on the CPU.

Each module is initialised in flax, every parameter perturbed (so unit
LayerNorm scales and zero biases do not hide a wrong mapping), carried over
with ``checkpoints/from_jax.py``, and fed the same numpy-seeded inputs (NHWC
for flax, NCHW for the port). fp32 within 2e-4 absolute plus 1e-4 relative
(ROADMAP.md's bar); bf16 (both sides computing in bf16 with fp32 parameters)
within 2% of the output's largest magnitude: each bf16 rounding is 2^-8
relative, a block rounds its activations at a dozen places that the two
frameworks do not share (XLA fuses, torch rounds per op), and JAX's own bf16
run lies 0.4-1.6% (of that magnitude) from its fp32 run on these inputs.

Also: ``multi_head_attention`` with keys != queries against ``_xla_attention``
and the Pallas ``flash_attention`` (interpret mode), K3's plan for Tk != Tq,
the transformer UNet's forward, loss and every gradient leaf (the JAX draws of
t and noise fed in), and the reference ``.pth`` map of a SpatialTransformer
composed with ``from_jax``. K3 with Tk != Tq on the card against its twin is
in ``tests/test_torch_ops.py`` (gpu-marked; that file imports no jax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_latent import lbbdm_config
from test_torch_layers import flax_run, load, nchw, unet_params

from bbdm_tpu.models import build_model as jax_build
from bbdm_tpu.models import cond as jc
from bbdm_tpu.models import layers as jl
from bbdm_tpu.models import unet as ju
from bbdm_tpu.ops.attention import _xla_attention
from bbdm_tpu_torch.checkpoints.from_jax import jax_tree_from_state_dict, state_dict_from_jax
from bbdm_tpu_torch.models import build_model as port_build
from bbdm_tpu_torch.models import cond as tc
from bbdm_tpu_torch.models import layers as tl
from bbdm_tpu_torch.models import unet as tu
from bbdm_tpu_torch.ops import attention

ATOL, RTOL = 2e-4, 1e-4
BF16_REL = 2e-2

RS = np.random.RandomState(0)
IMG = RS.randn(2, 8, 8, 64).astype(np.float32)       # NHWC, 64 channels
TOKENS = RS.randn(2, 16, 32).astype(np.float32)      # [B, T, C]
CONTEXT = RS.randn(2, 5, 24).astype(np.float32)      # [B, Tk, C'], Tk != T
CONTEXT_IMG = RS.randn(2, 4, 6, 24).astype(np.float32)  # NHWC context, 24 tokens
IDS = RS.randint(0, 50, (2, 7)).astype(np.int32)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def as_port(a, dtype=torch.float32):
    """A flax input as the port takes it: NHWC images as NCHW, ints as they are."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a)
    t = nchw(a) if a.ndim == 4 else torch.from_numpy(a)
    return t.to(dtype)


# name -> (flax module, port module factory (dtype), flax inputs)
CASES = {
    "cross_attention": (lambda dt: jl.CrossAttention(4, 8, 32, dtype=dt),
                        lambda dt: tl.CrossAttention(32, 4, 8, 32, context_dim=24, dtype=dt),
                        (TOKENS, CONTEXT)),
    "cross_attention_image_context": (
        lambda dt: jl.CrossAttention(4, 8, 32, dtype=dt),
        lambda dt: tl.CrossAttention(32, 4, 8, 32, context_dim=24, dtype=dt),
        (TOKENS, CONTEXT_IMG)),
    "self_attention": (lambda dt: jl.CrossAttention(4, 8, 48, dtype=dt),
                       lambda dt: tl.CrossAttention(32, 4, 8, 48, dtype=dt), (TOKENS,)),
    "geglu": (lambda dt: jl.GEGLUFeedForward(32, dtype=dt),
              lambda dt: tl.GEGLUFeedForward(32, dtype=dt), (TOKENS,)),
    "basic_transformer_block": (
        lambda dt: jl.BasicTransformerBlock(32, 4, 8, context_dim=24, dtype=dt),
        lambda dt: tl.BasicTransformerBlock(32, 4, 8, context_dim=24, dtype=dt),
        (TOKENS, CONTEXT)),
    "spatial_transformer": (
        lambda dt: jl.SpatialTransformer(4, 16, depth=2, context_dim=24, dtype=dt),
        lambda dt: tl.SpatialTransformer(64, 4, 16, depth=2, context_dim=24, dtype=dt),
        (IMG, CONTEXT_IMG)),
    "linear_attention": (lambda dt: jl.LinearAttention(4, 16, dtype=dt),
                         lambda dt: tl.LinearAttention(64, 4, 16, dtype=dt), (IMG,)),
    "spatial_self_attention": (lambda dt: jl.SpatialSelfAttention(dtype=dt),
                               lambda dt: tl.SpatialSelfAttention(64, dtype=dt), (IMG,)),
    "class_embedder": (lambda dt: jc.ClassEmbedder(16, 10),
                       lambda dt: tc.ClassEmbedder(16, 10), (np.array([3, 7, 0], np.int32),)),
    "transformer_embedder": (
        lambda dt: jc.TransformerEmbedder(32, 2, 50, max_seq_len=8, num_heads=4, dtype=dt),
        lambda dt: tc.TransformerEmbedder(32, 2, 50, max_seq_len=8, num_heads=4, dtype=dt),
        (IDS,)),
}


def run_case(name, jdt, tdt):
    make_flax, make_port, inputs = CASES[name]
    jin = tuple(jnp.asarray(a, jdt) if a.dtype.kind == "f" else a for a in inputs)
    params, ref = flax_run(make_flax(jdt), jin, init_args=inputs)
    port = load(make_port(tdt), params)
    out = port(*(as_port(a, tdt) for a in inputs))
    ref = np.asarray(ref, np.float32)
    got = nhwc(out) if out.ndim == 4 else out.detach().float().numpy()
    return got, ref


@pytest.mark.parametrize("name", list(CASES))
def test_module_matches_flax_fp32(name):
    got, ref = run_case(name, jnp.float32, torch.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", [n for n in CASES if n != "class_embedder"])
def test_module_matches_flax_bf16(name):
    """The class embedder is a table lookup with no compute dtype."""
    got, ref = run_case(name, jnp.bfloat16, torch.bfloat16)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()


def test_layer_norm_is_flax_in_fp32_for_a_bf16_input():
    """flax LayerNorm: eps 1e-6 and an fp32 result for bf16 x with fp32 parameters."""
    import flax.linen as nn

    x = jnp.asarray(TOKENS * 3 + 1, jnp.bfloat16)
    params, ref = flax_run(nn.LayerNorm(param_dtype=jnp.float32), (x,))
    port = load(tl.LayerNorm(32), params)
    out = port(torch.from_numpy(np.asarray(x, np.float32)).bfloat16())
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_cross_attention_refuses_a_context_of_another_width():
    port = tl.CrossAttention(32, 4, 8, 32, context_dim=16)
    with pytest.raises(ValueError, match="3 channels.*take 16"):
        port(torch.zeros(1, 4, 32), torch.zeros(1, 3, 2, 2))


# ------------------------------------------------ attention with Tk != Tq

@pytest.mark.parametrize("tk", [1, 7, 96])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_attention_with_other_key_count_matches_xla(tk, dtype):
    rs = np.random.RandomState(tk)
    q = rs.randn(2, 3, 40, 16).astype(np.float32)
    k, v = (rs.randn(2, 3, tk, 16).astype(np.float32) for _ in range(2))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype is np.float32
                else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(_xla_attention(*(jnp.asarray(a, jdt) for a in (q, k, v))), np.float32)
    out = attention.multi_head_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert out.shape == (2, 3, 40, 16)
    # bf16: the same roundings on both sides (scaled q, k and the weights), fp32 sums
    tol = ATOL if tdt == torch.float32 else 2 ** -7
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("tk", [1, 32, 96])
def test_attention_with_other_key_count_matches_pallas_flash(tk):
    """The Pallas kernel (interpret mode on the CPU) takes Tk != Tq with one key
    block of Tk (min(512, Tk)) and one query block of 64."""
    from bbdm_tpu.ops.flash_attention import flash_attention

    rs = np.random.RandomState(10 + tk)
    q = rs.randn(1, 2, 64, 128).astype(np.float32)
    k, v = (rs.randn(1, 2, tk, 128).astype(np.float32) for _ in range(2))
    ref = np.asarray(flash_attention(*(jnp.asarray(a) for a in (q, k, v))))
    out = attention.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq,tk,d", [(1024, 4096, 128), (1024, 1, 128), (4096, 1024, 512),
                                     (50, 3, 48), (1100, 77, 128)])
def test_flash_plan_pads_queries_and_keys_apart(dtype, tq, tk, d):
    """q and k, v are padded each to one 64-row TMA box on their own, D to one
    box of columns (64 bf16, 32 fp32); the shared memory depends on D alone."""
    if dtype == torch.bfloat16 and d % 8:
        pytest.skip("bf16 K3 takes D % 8 == 0")
    plan = attention.plan_flash(tq, tk, d, dtype)
    assert (plan.Tqm, plan.Tkm) == (max(tq, 64), max(tk, 64))
    assert plan.Dm == max(d, 32 if dtype == torch.float32 else 64)
    assert plan.DP == attention.flash_padded_dim(plan.Dm, dtype) >= plan.Dm
    smem = (attention.flash_f32_smem_bytes if dtype == torch.float32
            else attention.flash_smem_bytes)(plan.Dm)
    assert plan.smem == smem == (attention.plan_flash(tq, 1, d, dtype).smem)
    assert plan.smem <= 227 * 1024


@pytest.mark.parametrize("tq,tk,d,dtype", [(0, 4, 128, torch.float32), (64, 0, 128, torch.float32),
                                           (64, 4, 640, torch.bfloat16),
                                           (64, 4, 20, torch.bfloat16), (64, 4, 18, torch.float32)])
def test_flash_plan_names_what_the_kernel_does_not_take(tq, tk, d, dtype):
    with pytest.raises(ValueError, match=r"Tq, Tk, D >= 1|D % (8|4) == 0 and D <= 512"):
        attention.plan_flash(tq, tk, d, dtype)


# ------------------------------------------------------- transformer UNet

def xattn_params(**over):
    d = dict(use_spatial_transformer=True, transformer_depth=2, context_dim=3, in_channels=6,
             condition_key="SpatialRescaler", attention_resolutions=(2,))
    d.update(over)
    return unet_params(**d)


def seeded(port, seed):
    """``port`` with seeded weights, each perturbed (no zero head or unit
    scale left), and its JAX tree: flax's jitted init of a transformer UNet
    costs more CPU than the comparison itself."""
    from bbdm_tpu_torch.models.layers import init_parameters

    init_parameters(port, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in port.parameters():
            t.add_(0.05 * torch.randn(t.shape, generator=g))
    return port, jax_tree_from_state_dict(port)


def test_transformer_unet_matches_flax():
    p = xattn_params()
    rs = np.random.RandomState(3)
    x, ctx = (rs.randn(2, 8, 8, 3).astype(np.float32) for _ in range(2))
    t = np.array([5, 17], np.int32)
    port, params = seeded(tu.UNet.from_config(p, "SpatialRescaler", dtype=torch.float32,
                                              device="cpu").eval(), 3)
    jax_unet = ju.UNet.from_config(p, "SpatialRescaler", dtype=jnp.float32)
    ref = jax.jit(lambda p_, *a: jax_unet.apply({"params": p_}, *a))(params, x, t, ctx)
    assert isinstance(port.mid_attn, tl.SpatialTransformer) and port.mid_attn.depth == 2
    out = port(nchw(x), torch.from_numpy(t), nchw(ctx))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_head_channels,num_heads_upsample", [(8, -1), (-1, 2)])
def test_transformer_unet_keeps_the_jax_head_rule(num_head_channels, num_heads_upsample):
    """num_heads_upsample is ignored under the transformer; dim_head = ch // heads."""
    p = xattn_params(num_head_channels=num_head_channels, num_heads_upsample=num_heads_upsample)
    port = tu.UNet.from_config(p, "SpatialRescaler", dtype=torch.float32, device="cpu")
    jax_unet = ju.UNet.from_config(p, "SpatialRescaler", dtype=jnp.float32)
    for name, ch in (("down_1_0_attn", 64), ("mid_attn", 64), ("up_1_0_attn", 64)):
        attn1 = port.get_submodule(f"{name}.block_0.attn1")
        assert (attn1.heads, attn1.dim_head) == jax_unet._heads_for(ch, decoder="up" in name)


def test_transformer_unet_context_width_mismatch_names_both():
    """flax sizes to_k/to_v from the context; the port from context_dim, and a
    context of another width raises with both numbers."""
    p = xattn_params(context_dim=16)
    port = tu.UNet.from_config(p, "SpatialRescaler", dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="3 channels.*take 16"):
        port(torch.zeros(1, 3, 8, 8), torch.tensor([1]), torch.zeros(1, 3, 8, 8))


def xattn_lbbdm():
    cfg = lbbdm_config("SpatialRescaler")
    u = cfg.BB.params.UNetParams
    u.use_spatial_transformer, u.transformer_depth, u.context_dim = True, 1, 3
    return cfg


def test_transformer_lbbdm_loss_and_gradients_match_jax_grad():
    """LBBDM with a SpatialRescaler context fed to the transformers: the loss and
    every trainable gradient leaf against ``jax.grad``, the JAX draws of t and
    the noise fed in."""
    cfg = xattn_lbbdm()
    jm = jax_build(cfg)
    port, params = seeded(port_build(cfg, device="cpu"), 5)
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    y = np.clip(-x + rs.uniform(-0.2, 0.2, x.shape), -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(6)
    (loss, _), grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, key, x, y),
                                                  has_aux=True))(params)
    t_rng, n_rng = jax.random.split(key)
    zshape = jax.eval_shape(lambda p, x: jm.encode(p, x), params, x).shape
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, jm.num_timesteps)))
    noise = nchw(jax.random.normal(n_rng, zshape))

    port.train()
    ploss, _ = port.loss(nchw(x), nchw(y), t=t, noise=noise)
    ploss.backward()
    assert abs(ploss.item() - float(loss)) <= ATOL
    trainable = port.trainable_parameters()
    assert any(".block_0.attn2.to_k." in n for n in trainable)
    assert all(p.grad is not None for p in trainable.values())
    got = jax_tree_from_state_dict({n: p.grad for n, p in trainable.items()})
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == len(trainable)
    for path, g in flat:
        ref = grads
        for k in path:
            ref = ref[k.key]
        np.testing.assert_allclose(g, np.asarray(ref), rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- checkpoints

def test_new_leaves_convert_both_ways():
    """3-D DenseGeneral kernels and 2-D biases, nn.Embed tables, pos_emb and
    LayerNorm scales: JAX tree -> port -> JAX tree is the identity."""
    params, _ = flax_run(jc.TransformerEmbedder(32, 1, 50, max_seq_len=8, num_heads=4), (IDS,))
    port = load(tc.TransformerEmbedder(32, 1, 50, max_seq_len=8, num_heads=4), params)
    sd = port.state_dict()
    assert sd["attn_0.query.weight"].shape == (32, 4, 8)
    assert sd["attn_0.out.weight"].shape == (4, 8, 32)
    assert sd["token_emb.embedding"].shape == (50, 32) and sd["pos_emb"].shape == (8, 32)
    back = jax_tree_from_state_dict(port)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat_back.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_back[k], v)


def test_reference_spatial_transformer_map_loads_into_the_port():
    """``torch_import``'s SpatialTransformer map (reference ``.pth`` names)
    composed with ``from_jax`` fills every parameter of the port's transformer
    UNet, each with the value it was given: a reference state dict is made from
    seeded port weights by inverting each entry's transform."""
    from bbdm_tpu_torch.checkpoints import torch_import as ti

    inverse = {ti._t_linear: lambda a: a.T, ti._t_conv2d: lambda a: a.transpose(3, 2, 0, 1),
               ti._t_conv1d: lambda a: a.T[:, :, None], ti._ident: lambda a: a}
    dense = {"weight": (("kernel",), ti._t_linear), "bias": (("bias",), ti._ident)}
    maps = {**ti.unet_module_map(xattn_params(transformer_depth=1)),
            "time_embed.0": ("time_dense_0", dense), "time_embed.2": ("time_dense_1", dense),
            "out.0": ("out_norm", {"weight": (("scale",), ti._ident),
                                   "bias": (("bias",), ti._ident)}),
            "out.2": ("out_conv", {"weight": (("kernel",), ti._t_conv2d),
                                   "bias": (("bias",), ti._ident)})}
    p = xattn_params(transformer_depth=1)
    port = tu.UNet.from_config(p, "SpatialRescaler", dtype=torch.float32, device="cpu")
    rs = np.random.RandomState(4)
    given = {n: torch.from_numpy(rs.randn(*t.shape).astype(np.float32))
             for n, t in port.state_dict().items()}
    tree = jax_tree_from_state_dict(given)
    ref_sd = {}
    for prefix, (mod, pmap) in maps.items():
        for suffix, (path, to_flax) in pmap.items():
            leaf = tree.get(mod, {})
            for part in path:
                leaf = leaf.get(part, {}) if isinstance(leaf, dict) else leaf
            if isinstance(leaf, np.ndarray):
                ref_sd[f"denoise_fn.{prefix}.{suffix}"] = np.ascontiguousarray(
                    inverse[to_flax](leaf))
    assert any(".transformer_blocks.0.attn2.to_k.weight" in k for k in ref_sd)
    loaded = state_dict_from_jax(ti.convert_unet_state_dict(ref_sd, p), port)
    assert loaded.keys() == given.keys()
    for name, t in loaded.items():
        torch.testing.assert_close(t, given[name], rtol=0, atol=0, msg=name)
