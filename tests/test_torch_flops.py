"""The port's FLOP counter (``bbdm_tpu_torch/utils/flops.py``) against the JAX
package's (``bbdm_tpu/utils/flops.py``): for every YAML file under
``configs/`` and ``configs/runs/``, each read by its own package's loader,
with each sampler and each ``skip_sample``, the four functions give the same
float exactly (``==``): the same arithmetic in the same order."""

import glob
import os

import pytest

from bbdm_tpu.config import load_config as jax_load_config
from bbdm_tpu.utils import flops as jax_flops
from bbdm_tpu_torch.config import load_config
from bbdm_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def both(path):
    return load_config(os.path.join(REPO, path)), jax_load_config(os.path.join(REPO, path))


def test_every_config_directory_is_covered():
    assert {os.path.dirname(p) for p in CONFIGS} == {"configs", os.path.join("configs", "runs")}
    assert len(CONFIGS) >= 16


@pytest.mark.parametrize("path", CONFIGS)
def test_sampler_and_skip_sample_read_alike(path):
    """What the counter reads before any override: ``sampler`` (default euler)
    and ``skip_sample``, as the two loaders give them."""
    mine, ref = both(path)
    if "BB" not in ref.model:
        assert "BB" not in mine.model
        return
    a, b = mine.model.BB.params, ref.model.BB.params
    assert a.get("sampler", "euler") == b.get("sampler", "euler")
    assert a.skip_sample == b.skip_sample
    assert (a.sample_step, a.num_timesteps) == (b.sample_step, b.num_timesteps)


@pytest.mark.parametrize("skip_sample", [True, False])
@pytest.mark.parametrize("sampler", ["euler", "heun"])
@pytest.mark.parametrize("path", CONFIGS)
def test_flop_counts_equal_the_jax_counter(path, sampler, skip_sample):
    mine, ref = both(path)
    if "BB" not in ref.model:  # a VQGAN config: the first stage's counts only
        for kw in ({}, {"encode": False}, {"decode": False}):
            got = flops.vqgan_flops(mine.model.VQGAN.params, **kw)
            assert got == jax_flops.vqgan_flops(ref.model.VQGAN.params, **kw) and got >= 0
        for fn in ("sampling_flops_per_image", "training_flops_per_image"):
            with pytest.raises(AttributeError):
                getattr(jax_flops, fn)(ref.model)
            with pytest.raises(AttributeError):
                getattr(flops, fn)(mine.model)
        return
    for cfg in (mine, ref):
        cfg.model.BB.params.sampler = sampler
        cfg.model.BB.params.skip_sample = skip_sample
    unet = flops.unet_forward_flops(mine.model.BB.params.UNetParams)
    assert unet == jax_flops.unet_forward_flops(ref.model.BB.params.UNetParams) > 0
    assert (flops.sampling_flops_per_image(mine.model)
            == jax_flops.sampling_flops_per_image(ref.model))
    assert (flops.training_flops_per_image(mine.model)
            == jax_flops.training_flops_per_image(ref.model))
    if mine.model.model_type == "LBBDM":
        assert (flops.vqgan_flops(mine.model.VQGAN.params)
                == jax_flops.vqgan_flops(ref.model.VQGAN.params))


def test_template_counts():
    """The LBBDM-f4 template's counts: 200 euler steps and the heun NFE 2(S-1)+1."""
    cfg = load_config(os.path.join(REPO, "configs", "Template-LBBDM-f4.yaml")).model
    unet = flops.unet_forward_flops(cfg.BB.params.UNetParams)
    vq = flops.vqgan_flops(cfg.VQGAN.params)
    assert flops.sampling_flops_per_image(cfg) == 200 * unet + vq
    assert flops.training_flops_per_image(cfg) == 3 * unet + 2 * flops.vqgan_flops(
        cfg.VQGAN.params, decode=False)
    cfg.BB.params.sampler = "heun"
    assert flops.sampling_flops_per_image(cfg) == 399 * unet + vq
    assert round(unet / 1e11, 3) == 1.989
