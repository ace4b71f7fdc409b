"""The port's ``SpatialRescaler`` (``bbdm_tpu_torch/models/cond.py``) against
the JAX package's (``bbdm_tpu/models/cond.py``), which resizes with
``jax.image.resize(..., antialias=False)``: every method name JAX takes, at
multipliers 0.5, 0.75 and 2, with one and two stages, fp32 within 1e-5; a name
JAX refuses raises in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbdm_tpu.models.cond import SpatialRescaler as JaxRescaler
from bbdm_tpu_torch.models.cond import RESIZE_METHODS, SpatialRescaler, resize

METHODS = ["nearest", "linear", "bilinear", "trilinear", "triangle", "cubic", "bicubic",
           "tricubic", "lanczos3", "lanczos5"]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_the_port_takes_the_names_jax_takes():
    assert sorted(RESIZE_METHODS) == sorted(METHODS)


@pytest.mark.parametrize("n_stages", [1, 2])
@pytest.mark.parametrize("multiplier", [0.5, 0.75, 2])
@pytest.mark.parametrize("method", METHODS)
def test_spatial_rescaler_methods_match_jax(method, multiplier, n_stages):
    x = np.random.RandomState(n_stages).uniform(-1, 1, (2, 13, 16, 3)).astype(np.float32)
    jr = JaxRescaler(n_stages=n_stages, method=method, multiplier=multiplier,
                     dtype=jnp.float32)
    want = np.asarray(jr.apply({}, x))
    got = SpatialRescaler(3, n_stages=n_stages, method=method, multiplier=multiplier)(nchw(x))
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_nearest_takes_the_sample_under_each_centre():
    """6 -> 3 picks 1, 3, 5 (half-pixel centres), not F.interpolate's 0, 2, 4."""
    x = torch.arange(6, dtype=torch.float32).reshape(1, 1, 1, 6)
    assert resize(x, (1, 3), "nearest").flatten().tolist() == [1.0, 3.0, 5.0]


def test_an_unknown_method_raises_as_jax_raises():
    with pytest.raises(ValueError, match='Unknown resize method "area"'):
        JaxRescaler(method="area").apply({}, np.zeros((1, 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match='Unknown resize method "area"'):
        SpatialRescaler(3, method="area")
