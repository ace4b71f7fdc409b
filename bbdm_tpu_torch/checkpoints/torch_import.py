"""Reference PyTorch checkpoints -> the JAX package's parameter trees, in numpy
(the port's own copy of ``bbdm_tpu/checkpoints/torch_import.py:27-504``).

Covers the BBDM/LBBDM training checkpoints of the reference repo
(``{'model': state_dict, 'ema': shadow, 'step', 'epoch'[, latent stats]}``),
bare LDM VQGAN checkpoints (``{'state_dict': ...}``) and full taming/LDM
VQGAN training checkpoints (the autoencoder with its PatchGAN). The trees these
functions return load into the port through
``checkpoints/from_jax.py:state_dict_from_jax`` (the only name map between
the flax layout and the port's modules).

Weight layouts (torch -> flax NHWC): Linear [out,in] -> kernel [in,out];
Conv2d [O,I,kh,kw] -> kernel [kh,kw,I,O]; Conv1d [O,I,1] (attention) -> dense
kernel [I,O]; GroupNorm weight/bias -> scale/bias. The UNet block indices are
replayed from the reference's construction order (``openaimodel.py:521-703``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _t_linear(w):  # [out,in] -> [in,out]
    return np.ascontiguousarray(np.asarray(w).T)


def _t_conv2d(w):  # OIHW -> HWIO
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def _t_conv1d(w):  # [O,I,1] -> [I,O]
    return np.ascontiguousarray(np.asarray(w)[:, :, 0].T)


def _ident(w):
    return np.asarray(w)


# map entries: torch_suffix -> (flax_path_tuple, transform)
_RESBLOCK_PARAMS = {
    "in_layers.0.weight": (("in_norm", "scale"), _ident),
    "in_layers.0.bias": (("in_norm", "bias"), _ident),
    "in_layers.2.weight": (("in_conv", "kernel"), _t_conv2d),
    "in_layers.2.bias": (("in_conv", "bias"), _ident),
    "emb_layers.1.weight": (("emb_proj", "kernel"), _t_linear),
    "emb_layers.1.bias": (("emb_proj", "bias"), _ident),
    "out_layers.0.weight": (("out_norm", "scale"), _ident),
    "out_layers.0.bias": (("out_norm", "bias"), _ident),
    "out_layers.3.weight": (("out_conv", "kernel"), _t_conv2d),
    "out_layers.3.bias": (("out_conv", "bias"), _ident),
    "skip_connection.weight": (("skip", "kernel"), _t_conv2d),
    "skip_connection.bias": (("skip", "bias"), _ident),
}

_ATTNBLOCK_PARAMS = {
    "norm.weight": (("norm", "scale"), _ident),
    "norm.bias": (("norm", "bias"), _ident),
    "qkv.weight": (("qkv", "kernel"), _t_conv1d),
    "qkv.bias": (("qkv", "bias"), _ident),
    "proj_out.weight": (("proj_out", "kernel"), _t_conv1d),
    "proj_out.bias": (("proj_out", "bias"), _ident),
}

def _spatial_transformer_params(depth: int) -> dict:
    """Param map for a reference SpatialTransformer (`attention.py:221-264`):
    GroupNorm + 1x1 proj convs around `depth` BasicTransformerBlocks
    (attn1/attn2 CrossAttention with bias-free q/k/v Linears + to_out
    Sequential, GEGLU feed-forward, three LayerNorms)."""
    pmap = {
        "norm.weight": (("norm", "scale"), _ident),
        "norm.bias": (("norm", "bias"), _ident),
        "proj_in.weight": (("proj_in", "kernel"), _t_conv2d),
        "proj_in.bias": (("proj_in", "bias"), _ident),
        "proj_out.weight": (("proj_out", "kernel"), _t_conv2d),
        "proj_out.bias": (("proj_out", "bias"), _ident),
    }
    for d in range(depth):
        t = f"transformer_blocks.{d}"
        blk = f"block_{d}"
        for ln in ("norm1", "norm2", "norm3"):
            pmap[f"{t}.{ln}.weight"] = ((blk, ln, "scale"), _ident)
            pmap[f"{t}.{ln}.bias"] = ((blk, ln, "bias"), _ident)
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                pmap[f"{t}.{attn}.{proj}.weight"] = ((blk, attn, proj, "kernel"), _t_linear)
            pmap[f"{t}.{attn}.to_out.0.weight"] = ((blk, attn, "to_out", "kernel"), _t_linear)
            pmap[f"{t}.{attn}.to_out.0.bias"] = ((blk, attn, "to_out", "bias"), _ident)
        pmap[f"{t}.ff.net.0.proj.weight"] = ((blk, "ff", "proj", "kernel"), _t_linear)
        pmap[f"{t}.ff.net.0.proj.bias"] = ((blk, "ff", "proj", "bias"), _ident)
        pmap[f"{t}.ff.net.2.weight"] = ((blk, "ff", "out", "kernel"), _t_linear)
        pmap[f"{t}.ff.net.2.bias"] = ((blk, "ff", "out", "bias"), _ident)
    return pmap


_UPDOWN_PARAMS = {  # Upsample.conv / Downsample.op
    "conv.weight": (("conv", "kernel"), _t_conv2d),
    "conv.bias": (("conv", "bias"), _ident),
    "op.weight": (("op", "kernel"), _t_conv2d),
    "op.bias": (("op", "bias"), _ident),
}


def unet_module_map(unet_params) -> Dict[str, Tuple[str, dict]]:
    """torch 'input_blocks.3.0'-style prefixes -> (flax module name, param map).

    Replays the reference UNetModel layout (`openaimodel.py:521-703`).
    """
    p = unet_params
    mults = tuple(p.channel_mult)
    nrb = p.num_res_blocks
    attn = tuple(p.attention_resolutions)
    resblock_updown = p.get("resblock_updown", False)

    attn_params = (
        _spatial_transformer_params(p.get("transformer_depth", 1))
        if p.get("use_spatial_transformer", False) else _ATTNBLOCK_PARAMS
    )

    mapping: Dict[str, Tuple[str, dict]] = {}
    mapping["input_blocks.0.0"] = ("stem", {"weight": (("kernel",), _t_conv2d),
                                            "bias": (("bias",), _ident)})

    tidx = 1
    ds = 1
    for level in range(len(mults)):
        for i in range(nrb):
            mapping[f"input_blocks.{tidx}.0"] = (f"down_{level}_{i}", _RESBLOCK_PARAMS)
            if ds in attn:
                mapping[f"input_blocks.{tidx}.1"] = (f"down_{level}_{i}_attn", attn_params)
            tidx += 1
        if level != len(mults) - 1:
            params = _RESBLOCK_PARAMS if resblock_updown else _UPDOWN_PARAMS
            mapping[f"input_blocks.{tidx}.0"] = (f"down_{level}_ds", params)
            tidx += 1
            ds *= 2

    mapping["middle_block.0"] = ("mid_res_0", _RESBLOCK_PARAMS)
    mapping["middle_block.1"] = ("mid_attn", attn_params)
    mapping["middle_block.2"] = ("mid_res_1", _RESBLOCK_PARAMS)

    tidx = 0
    for level in reversed(range(len(mults))):
        for i in range(nrb + 1):
            mapping[f"output_blocks.{tidx}.0"] = (f"up_{level}_{i}", _RESBLOCK_PARAMS)
            sub = 1
            if ds in attn:
                mapping[f"output_blocks.{tidx}.{sub}"] = (f"up_{level}_{i}_attn", attn_params)
                sub += 1
            if level and i == nrb:
                params = _RESBLOCK_PARAMS if resblock_updown else _UPDOWN_PARAMS
                mapping[f"output_blocks.{tidx}.{sub}"] = (f"up_{level}_us", params)
                ds //= 2
            tidx += 1
    return mapping


def convert_unet_state_dict(sd: dict, unet_params, prefix: str = "denoise_fn.") -> dict:
    """torch UNet state_dict -> flax param tree (our UNet module layout)."""
    mod_map = unet_module_map(unet_params)
    out: dict = {}

    def put(path, value):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(value, dtype=np.float32)

    top = {
        "time_embed.0.weight": (("time_dense_0", "kernel"), _t_linear),
        "time_embed.0.bias": (("time_dense_0", "bias"), _ident),
        "time_embed.2.weight": (("time_dense_1", "kernel"), _t_linear),
        "time_embed.2.bias": (("time_dense_1", "bias"), _ident),
        "out.0.weight": (("out_norm", "scale"), _ident),
        "out.0.bias": (("out_norm", "bias"), _ident),
        "out.2.weight": (("out_conv", "kernel"), _t_conv2d),
        "out.2.bias": (("out_conv", "bias"), _ident),
    }

    unmatched = []
    for key, value in sd.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        if k in top:
            path, tf = top[k]
            put(path, tf(value))
            continue
        matched = False
        for torch_prefix, (flax_name, pmap) in mod_map.items():
            if k.startswith(torch_prefix + "."):
                suffix = k[len(torch_prefix) + 1:]
                if suffix in pmap:
                    path, tf = pmap[suffix]
                    put((flax_name,) + path, tf(value))
                    matched = True
                break
        if not matched:
            unmatched.append(key)
    if unmatched:
        raise ValueError(f"unmatched UNet keys: {unmatched[:10]} (+{len(unmatched) - 10 if len(unmatched) > 10 else 0})")
    return out


_VQ_RESNET = {
    "norm1.weight": (("norm1", "scale"), _ident),
    "norm1.bias": (("norm1", "bias"), _ident),
    "conv1.weight": (("conv1", "kernel"), _t_conv2d),
    "conv1.bias": (("conv1", "bias"), _ident),
    "norm2.weight": (("norm2", "scale"), _ident),
    "norm2.bias": (("norm2", "bias"), _ident),
    "conv2.weight": (("conv2", "kernel"), _t_conv2d),
    "conv2.bias": (("conv2", "bias"), _ident),
    "nin_shortcut.weight": (("nin_shortcut", "kernel"), _t_conv2d),
    "nin_shortcut.bias": (("nin_shortcut", "bias"), _ident),
}

_VQ_ATTN = {
    "norm.weight": (("norm", "scale"), _ident),
    "norm.bias": (("norm", "bias"), _ident),
    **{f"{n}.weight": ((n, "kernel"), _t_conv2d) for n in ("q", "k", "v", "proj_out")},
    **{f"{n}.bias": ((n, "bias"), _ident) for n in ("q", "k", "v", "proj_out")},
}


def convert_vqgan_state_dict(sd: dict, prefix: str = "") -> dict:
    """LDM VQModel state_dict -> flax param tree (our VQModel layout).

    Handles encoder/decoder down/up blocks, attn blocks, mid blocks,
    quantizer codebook and the pre/post quant convs. torch module names like
    'encoder.down.0.block.1.conv1.weight' become
    params['encoder']['down_0_block_1']['conv1']['kernel'].
    """
    out: dict = {}

    def put(path, value):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(value, dtype=np.float32)

    def sub_map(parts):
        """(flax module name, remaining suffix) for an encoder/decoder key."""
        # parts after 'encoder'/'decoder'
        if parts[0] in ("conv_in", "conv_out"):
            return parts[0], parts[1:]
        if parts[0] == "norm_out":
            return "norm_out", parts[1:]
        if parts[0] == "mid":
            name = {"block_1": "mid_block_1", "attn_1": "mid_attn_1",
                    "block_2": "mid_block_2"}[parts[1]]
            return name, parts[2:]
        if parts[0] in ("down", "up"):
            level = parts[1]
            kind = parts[2]
            if kind == "block":
                return f"{parts[0]}_{level}_block_{parts[3]}", parts[4:]
            if kind == "attn":
                return f"{parts[0]}_{level}_attn_{parts[3]}", parts[4:]
            if kind in ("downsample", "upsample"):
                return f"{parts[0]}_{level}_{kind}", parts[3:]
        raise KeyError(".".join(parts))

    unmatched = []
    for key, value in sd.items():
        if prefix and not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        parts = k.split(".")
        try:
            if parts[0] in ("encoder", "decoder"):
                name, rest = sub_map(parts[1:])
                suffix = ".".join(rest)
                if name in ("conv_in", "conv_out") or name.endswith("sample"):
                    # plain conv modules: suffix is 'weight'/'bias' or 'conv.weight'
                    if rest[0] == "conv":
                        path = (parts[0], name, "conv",
                                "kernel" if rest[1] == "weight" else "bias")
                        tf = _t_conv2d if rest[1] == "weight" else _ident
                    else:
                        path = (parts[0], name, "kernel" if rest[0] == "weight" else "bias")
                        tf = _t_conv2d if rest[0] == "weight" else _ident
                    put(path, tf(value))
                elif name == "norm_out":
                    put((parts[0], "norm_out", "scale" if rest[0] == "weight" else "bias"),
                        value)
                elif "attn" in name:
                    path, tf = _VQ_ATTN[suffix]
                    put((parts[0], name) + path, tf(value))
                else:  # resnet block
                    path, tf = _VQ_RESNET[suffix]
                    put((parts[0], name) + path, tf(value))
            elif parts[0] == "quantize":
                # VectorQuantizer2: quantize.embedding.weight -> embedding.
                # GumbelVQ: quantize.proj.{weight,bias} (1x1 conv) +
                # quantize.embed.weight -> proj/* + embedding. Anything else
                # (e.g. a remap buffer) is unmatched, not silently folded in.
                if k == "quantize.embedding.weight" or k == "quantize.embed.weight":
                    put(("quantize", "embedding"), value)
                elif k == "quantize.proj.weight":
                    put(("quantize", "proj", "kernel"), _t_conv2d(value))
                elif k == "quantize.proj.bias":
                    put(("quantize", "proj", "bias"), value)
                else:
                    unmatched.append(key)
            elif parts[0] in ("quant_conv", "post_quant_conv"):
                tf = _t_conv2d if parts[1] == "weight" else _ident
                put((parts[0], "kernel" if parts[1] == "weight" else "bias"), tf(value))
            elif parts[0] == "loss":
                continue  # GAN loss stack — not used at inference
            else:
                unmatched.append(key)
        except KeyError:
            unmatched.append(key)
    if unmatched:
        raise ValueError(f"unmatched VQGAN keys: {unmatched[:10]}")
    return out


def convert_cond_stage_state_dict(sd: dict, prefix: str = "cond_stage_model.") -> dict:
    """SpatialRescaler (optional 1x1 channel mapper)."""
    out = {}
    for key, value in sd.items():
        if not key.startswith(prefix):
            continue
        k = key[len(prefix):]
        if k == "channel_mapper.weight":
            out.setdefault("channel_mapper", {})["kernel"] = _t_conv2d(value)
        elif k == "channel_mapper.bias":
            out.setdefault("channel_mapper", {})["bias"] = _ident(value)
    return out


def convert_discriminator_state_dict(sd: dict, *, n_layers: int = 3,
                                     use_actnorm: bool = False,
                                     prefix: str = "") -> tuple:
    """Reference NLayerDiscriminator state_dict -> (params, batch_stats).

    The reference builds one nn.Sequential ``main``: conv at index 0, then per
    rung n=1..n_layers a (conv, norm, leaky) triple at indices 2+(n-1)*3 /
    3+(n-1)*3, and the 1-channel patch head at 2+n_layers*3. The flax module
    names them conv_0..conv_{n_layers}/norm_n/conv_out. ``batch_stats`` is
    None with ActNorm (whose loc/scale [1,C,1,1] buffers become (C,) params).
    """
    conv_names = {"0": "conv_0", str(2 + n_layers * 3): "conv_out"}
    norm_names = {}
    for n in range(1, n_layers + 1):
        conv_names[str(2 + (n - 1) * 3)] = f"conv_{n}"
        norm_names[str(3 + (n - 1) * 3)] = f"norm_{n}"

    params: dict = {}
    stats: dict = {}
    for key, value in sd.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split(".")
        if parts[0] != "main":
            continue
        idx, leaf = parts[1], parts[-1]
        if idx in conv_names:
            node = params.setdefault(conv_names[idx], {})
            if leaf == "weight":
                node["kernel"] = _t_conv2d(value)
            elif leaf == "bias":
                node["bias"] = _ident(value)
        elif idx in norm_names:
            name = norm_names[idx]
            if use_actnorm:
                # torch ActNorm: h = scale * (x + loc), buffers [1,C,1,1]
                if leaf in ("loc", "scale"):
                    params.setdefault(name, {})[leaf] = _ident(value).reshape(-1)
            else:
                node = params.setdefault(name, {})
                if leaf == "weight":
                    node["scale"] = _ident(value)
                elif leaf == "bias":
                    node["bias"] = _ident(value)
                elif leaf == "running_mean":
                    stats.setdefault(name, {})["mean"] = _ident(value)
                elif leaf == "running_var":
                    stats.setdefault(name, {})["var"] = _ident(value)
    return params, (None if use_actnorm else stats)


def _to_numpy_state_dict(sd):
    out = {}
    for k, v in sd.items():
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def load_torch_file(path: str) -> dict:
    """``torch.load`` of a reference checkpoint (pickled Python objects: only
    open files you trust)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def convert_reference_checkpoint(path: str, model_config) -> dict:
    """Full reference training checkpoint (.pth) -> our model-ckpt dict
    (same content contract as bbdm_tpu.checkpoints.io)."""
    raw = load_torch_file(path)
    sd = _to_numpy_state_dict(raw["model"])
    unet_params = model_config.BB.params.UNetParams

    params = {"unet": convert_unet_state_dict(sd, unet_params, prefix="denoise_fn.")}
    if model_config.model_type == "LBBDM":
        params["vqgan"] = convert_vqgan_state_dict(sd, prefix="vqgan.")
        if unet_params.condition_key == "SpatialRescaler":
            cs = convert_cond_stage_state_dict(sd)
            if cs:
                params["cond_stage"] = cs

    out = {
        "model": params,
        "step": int(raw.get("step", 0)),
        "epoch": int(raw.get("epoch", 0)),
    }
    if "ema" in raw:
        ema_sd = _to_numpy_state_dict(raw["ema"])
        ema = {"unet": convert_unet_state_dict(ema_sd, unet_params, prefix="denoise_fn.")}
        if model_config.model_type == "LBBDM":
            ema["vqgan"] = params["vqgan"]  # frozen — not in the shadow dict
            if "cond_stage" in params:
                cs = convert_cond_stage_state_dict(ema_sd)
                ema["cond_stage"] = cs if cs else params["cond_stage"]
        out["ema"] = ema
    for k in ("ori_latent_mean", "ori_latent_std", "cond_latent_mean", "cond_latent_std"):
        if k in raw:
            v = np.asarray(raw[k].detach().cpu().numpy() if hasattr(raw[k], "detach") else raw[k])
            out[k] = v.transpose(0, 2, 3, 1) if v.ndim == 4 else v  # NCHW stats -> NHWC
    return out


def convert_ldm_vqgan_checkpoint(path: str) -> dict:
    """Bare LDM VQGAN ckpt ({'state_dict': ...}) -> flax vqgan param tree."""
    raw = load_torch_file(path)
    sd = _to_numpy_state_dict(raw.get("state_dict", raw))
    return convert_vqgan_state_dict(sd)


def convert_vqgan_train_checkpoint(path: str) -> tuple:
    """Full taming/LDM VQGAN training ckpt -> (VQGANRunner resume dict, LPIPS
    tree or None).

    Such checkpoints carry the autoencoder, ``loss.discriminator.main.*`` (the
    taming NLayerDiscriminator) and ``loss.perceptual_loss.*`` (LPIPS-VGG). The
    resume dict follows the VQGAN runner's model checkpoint (step and epoch 0
    for a fresh fine-tune) with the ``disc_config`` the runner checks at load;
    discriminator depth and ActNorm use are read from the state_dict. The
    LPIPS weights come back in the JAX package's layout
    (``evaluation.lpips.lpips_tree_from_state_dict``; ``state_dict_from_lpips_tree``
    takes it to ``LPIPS("vgg")``), None where the checkpoint has none.
    """
    raw = load_torch_file(path)
    sd = _to_numpy_state_dict(raw.get("state_dict", raw))
    vq = convert_vqgan_state_dict(sd)

    disc_prefix = "loss.discriminator."
    idxs = sorted({int(k.split(".")[3]) for k in sd if k.startswith(disc_prefix + "main.")})
    if not idxs:
        raise ValueError(
            f"{path}: no '{disc_prefix}main.*' keys — not a full VQGAN training checkpoint "
            "(use the plain 'vqgan' conversion for inference-only first stages)")
    # main = [conv, leaky, (conv, norm, leaky) * n_layers, head]
    n_layers = (max(idxs) - 2) // 3
    use_actnorm = any(k.endswith(".loc") for k in sd if k.startswith(disc_prefix + "main."))
    disc, stats = convert_discriminator_state_dict(
        sd, n_layers=n_layers, use_actnorm=use_actnorm, prefix=disc_prefix)

    lp_prefix = "loss.perceptual_loss."
    lp_sd = {k[len(lp_prefix):]: v for k, v in sd.items() if k.startswith(lp_prefix)}
    lpips = None
    if lp_sd:
        from bbdm_tpu_torch.evaluation.lpips import lpips_tree_from_state_dict

        lpips = lpips_tree_from_state_dict(lp_sd)
    resume = {
        "step": 0,
        "epoch": 0,
        "model": {"vqgan": vq, "discriminator": disc, "disc_stats": stats},
        "disc_config": {
            "disc_num_layers": n_layers,
            "use_actnorm": use_actnorm,
            "disc_ndf": int(disc["conv_0"]["kernel"].shape[-1]),
        },
    }
    return resume, lpips
