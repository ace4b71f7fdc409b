"""The port's UNet and VQGAN modules against the flax modules, fp32 on the CPU.

Each case initialises the flax module, perturbs every parameter (so zero-init
heads and unit GroupNorm scales do not hide a wrong mapping), carries the
weights over with ``checkpoints/from_jax.py`` and runs the same numpy-seeded
inputs (NHWC for flax, NCHW for the port) through both. The bar is 2e-4 in
fp32, the parity bar of the JAX package against the torch reference
(docs/ARCHITECTURE.md:207-208).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.models import layers as jl
from bbdm_tpu.models import unet as ju
from bbdm_tpu.models import vqgan as jv
from bbdm_tpu_torch.checkpoints.from_jax import state_dict_from_jax
from bbdm_tpu_torch.models import layers as tl
from bbdm_tpu_torch.models import unet as tu
from bbdm_tpu_torch.models import vqgan as tv

ATOL = 2e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def perturbed(params, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rs.randn(*p.shape)).astype(np.float32), params)


def flax_run(module, args, *, method=None, init_args=None, seed=0):
    """Init (perturbed) and apply a flax module; returns (numpy params, numpy output)."""
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), *(init_args or args))
    params = perturbed(variables["params"], seed)
    out = jax.jit(lambda p, *a: module.apply({"params": p}, *a, method=method))(params, *args)
    return params, out


def load(port, params):
    port.load_state_dict(state_dict_from_jax(params, port))
    return port.eval()


def close(port_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(port_out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jax_out), rtol=1e-4, atol=atol)


@pytest.mark.parametrize("in_ch,out_ch,up,down,film", [
    (32, 64, False, False, True),   # 1x1 skip conv, FiLM
    (64, 64, True, False, True),    # up: subpixel in_conv, nearest skip
    (64, 64, False, True, True),    # down: avg-pool both paths
    (64, 64, False, False, False),  # emb added before the out norm
])
def test_resblock_matches_flax(in_ch, out_ch, up, down, film):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 8, in_ch).astype(np.float32)
    emb = rs.randn(2, 128).astype(np.float32)
    params, ref = flax_run(
        jl.ResBlock(out_ch, use_scale_shift_norm=film, up=up, down=down), (x, emb))
    port = load(tl.ResBlock(in_ch, out_ch, 128, use_scale_shift_norm=film, up=up,
                            down=down), params)
    close(port(nchw(x), torch.from_numpy(emb)), ref)


def test_attention_block_matches_flax():
    x = np.random.RandomState(2).randn(2, 8, 8, 64).astype(np.float32)
    params, ref = flax_run(jl.AttentionBlock(num_heads=4), (x,))
    close(load(tl.AttentionBlock(64, 4), params)(nchw(x)), ref)


def unet_params(**over):
    d = {"image_size": 8, "in_channels": 3, "model_channels": 32, "out_channels": 3,
         "num_res_blocks": 1, "attention_resolutions": (2,), "channel_mult": (1, 2),
         "conv_resample": True, "dims": 2, "num_heads": 4, "num_head_channels": 8,
         "use_scale_shift_norm": True, "resblock_updown": True,
         "use_spatial_transformer": False, "context_dim": None, "condition_key": "nocond"}
    d.update(over)
    return dict2namespace(d)


@pytest.mark.parametrize("resblock_updown", [True, False])
def test_unet_matches_flax(resblock_updown):
    p = unet_params(resblock_updown=resblock_updown)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 3).astype(np.float32)
    t = np.array([5, 17], np.int32)
    params, ref = flax_run(ju.UNet.from_config(p, "nocond", dtype=jnp.float32), (x, t))
    port = load(tu.UNet.from_config(p, "nocond", dtype=torch.float32), params)
    close(port(nchw(x), torch.from_numpy(t)), ref)


def test_unet_rejects_dims_other_than_2():
    with pytest.raises(NotImplementedError):
        tu.UNet.from_config(unet_params(dims=3), "nocond")


@pytest.mark.parametrize("name", ["resnet", "attn", "downsample", "upsample"])
def test_vq_block_matches_flax(name):
    x = np.random.RandomState(4).randn(2, 8, 8, 64).astype(np.float32)
    flax_mod, port_mod = {
        "resnet": (jv.VQResnetBlock(32), tv.VQResnetBlock(64, 32)),
        "attn": (jv.VQAttnBlock(), tv.VQAttnBlock(64)),
        "downsample": (jv.VQDownsample(), tv.VQDownsample(64)),
        "upsample": (jv.VQUpsample(), tv.VQUpsample(64)),
    }[name]
    params, ref = flax_run(flax_mod, (x,))
    close(load(port_mod, params)(nchw(x)), ref)


@pytest.fixture(scope="module")
def vq_pair():
    vq = dict2namespace({"embed_dim": 3, "n_embed": 32, "ddconfig": {
        "double_z": False, "z_channels": 3, "resolution": 16, "in_channels": 3,
        "out_ch": 3, "ch": 32, "ch_mult": (1, 2), "num_res_blocks": 1,
        "attn_resolutions": [8], "dropout": 0.0}})
    img = np.random.RandomState(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    flax_vq = jv.VQModel.from_config(vq)
    params, _ = flax_run(flax_vq, (img,))
    return flax_vq, params, load(tv.VQModel.from_config(vq), params), img


def test_vq_encoder_matches_flax(vq_pair):
    flax_vq, params, port, img = vq_pair
    ref = jax.jit(lambda p, x: flax_vq.apply({"params": p}, x,
                                             method=jv.VQModel.encode_latent))(params, img)
    close(port.encode_latent(nchw(img)), ref)


def test_vq_quantize_and_decoder_match_flax(vq_pair):
    flax_vq, params, port, _ = vq_pair
    rs = np.random.RandomState(6)
    z = (rs.randn(2, 8, 8, 3) * 0.05).astype(np.float32)
    zq, _, idx = jax.jit(lambda p, z: flax_vq.apply(
        {"params": p}, z, method=jv.VQModel.quantize_latent))(params, z)
    pzq, _, pidx = port.quantize_latent(nchw(z))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    close(pzq, zq, atol=0)
    ref = jax.jit(lambda p, q: flax_vq.apply(
        {"params": p}, q, method=jv.VQModel.decode_from_quant))(params, zq)
    close(port.decode_from_quant(pzq), ref)
