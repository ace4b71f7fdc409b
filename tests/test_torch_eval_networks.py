"""The port's metric networks (``bbdm_tpu_torch/evaluation/{inception,lpips}.py``)
against the JAX package's (``bbdm_tpu/evaluation/{inception,lpips}.py``), on the CPU.

The JAX parameters are built from the port's random weights with the JAX
package's own converters (``convert_inception_state_dict``,
``convert_lpips_state_dict``), never with flax ``init`` (a minute of CPU for
InceptionV3). Inputs come from a numpy seed. Bars (fp32): InceptionV3 features
1e-4 of each image's feature norm (He-random kernels and non-trivial BatchNorm
statistics, with the 64 -> 299 resize and without it at 75^2, the least input
the network takes); the resize alone 1e-6; LPIPS distances 1e-5 relative.
The torch mirrors of pytorch_fid's and lpips's networks
(``tests/torch_mirrors.py``, the pip packages' state-dict names) load strictly
and give the same outputs: that is how the real weights load.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval_metrics import he_inception, random_lpips

from bbdm_tpu.checkpoints.io import save_checkpoint
from bbdm_tpu.evaluation.inception import FIDInceptionV3 as JaxInception
from bbdm_tpu.evaluation.inception import convert_inception_state_dict
from bbdm_tpu.evaluation.lpips import convert_lpips_state_dict, lpips_distance
from bbdm_tpu_torch.evaluation import fid as pfid
from bbdm_tpu_torch.evaluation import lpips as plp
from bbdm_tpu_torch.evaluation.inception import (
    FIDInceptionV3,
    inception_state_dict,
    inception_tree_from_state_dict,
    resize_299,
    state_dict_from_inception_tree,
)
from tests.torch_mirrors import FIDInceptionMirror, LPIPSMirror

nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def inception():
    """(the port's He-random InceptionV3, the JAX tree of its weights)."""
    m = he_inception()
    return m, convert_inception_state_dict(m.state_dict())


# ---------------------------------------------------------------- InceptionV3

@pytest.mark.parametrize("size,resize", [(64, True), (75, False)])
def test_inception_features_match_jax(inception, size, resize):
    model, tree = inception
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(JaxInception(resize_input=resize).apply({"params": tree}, jnp.asarray(x)))
    model.resize_input = resize
    try:
        with torch.no_grad():
            got = model(nchw(x)).numpy()
    finally:
        model.resize_input = True
    assert got.shape == want.shape == (2, 2048)
    err = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert (err <= 1e-4).all(), err


@pytest.mark.parametrize("size", [64, 320])
def test_resize_matches_jax_image_resize(size):
    """Up (64 -> 299) and down (320 -> 299): bilinear, half-pixel centres, no antialiasing."""
    x = np.random.RandomState(size).rand(2, size, size + 8, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear",
                                       antialias=False))
    got = resize_299(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inception_loads_the_pytorch_fid_layout_strictly(inception):
    """A pytorch_fid state dict (the mirror's: BatchNorm2d with
    num_batches_tracked) loads strictly once ``fc``/``AuxLogits``/
    ``num_batches_tracked`` are dropped, and gives the mirror's features."""
    torch.manual_seed(7)
    mirror = FIDInceptionMirror(resize_input=False).eval()
    sd = dict(mirror.state_dict(), **{"fc.weight": torch.zeros(1008, 2048),
                                      "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1)})
    port = FIDInceptionV3(resize_input=False)
    port.load_state_dict(inception_state_dict(sd), strict=True)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 3, 75, 75).astype(np.float32))
    with torch.no_grad():
        want, got = mirror(x), port(x)
    assert (torch.linalg.vector_norm(got - want, dim=1)
            <= 1e-4 * torch.linalg.vector_norm(want, dim=1)).all()


def test_inception_converters_both_ways(inception):
    model, tree = inception
    sd = model.state_dict()
    assert_trees_equal(inception_tree_from_state_dict(sd), tree)
    assert_state_dicts_equal(state_dict_from_inception_tree(tree), sd)
    FIDInceptionV3().load_state_dict(state_dict_from_inception_tree(tree), strict=True)


# ---------------------------------------------------------------------- LPIPS

@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_distance_matches_jax(net):
    model = random_lpips(net)
    tree = convert_lpips_state_dict(model.state_dict(), net)
    rs = np.random.RandomState(1)
    a, b = (rs.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(lpips_distance(tree, net, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = model(nchw(a), nchw(b)).numpy()
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_loads_the_lpips_layout_strictly(net):
    """The mirror's state dict (``lpips.LPIPS``'s names) loads strictly and gives
    the mirror's distances; so does lpips's own layout (``scaling_layer.*``, the
    ``lins.{k}`` aliases of ``lin{k}``)."""
    torch.manual_seed(8)
    mirror = LPIPSMirror(net).eval()
    sd = mirror.state_dict()
    port = plp.LPIPS(net)
    port.load_state_dict(sd, strict=True)
    lpips_layout = {("scaling_layer." + k if k in ("shift", "scale") else k): v
                    for k, v in sd.items()}
    lpips_layout.update({f"lins.{k[3]}.model.1.weight": v for k, v in sd.items()
                         if k.startswith("lin")})
    other = plp.LPIPS(net)
    other.load_state_dict(plp.lpips_state_dict(lpips_layout), strict=True)
    rs = np.random.RandomState(2)
    a, b = (torch.from_numpy(rs.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
            for _ in range(2))
    with torch.no_grad():
        want = mirror(a, b)
        torch.testing.assert_close(port(a, b), want, rtol=1e-5, atol=0)
        torch.testing.assert_close(other(a, b), want, rtol=0, atol=0)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_converters_both_ways(net):
    sd = random_lpips(net).state_dict()
    tree = convert_lpips_state_dict(sd, net)
    assert_trees_equal(plp.lpips_tree_from_state_dict(sd), tree)
    assert_state_dicts_equal(plp.state_dict_from_lpips_tree(tree, net), sd)


def test_loaders_take_pth_and_jax_trees_and_name_a_missing_file(inception, tmp_path,
                                                                 monkeypatch):
    """``load_fid_params`` / ``load_lpips_params``: a torch ``.pth`` and the JAX
    package's ``.ckpt`` tree give the same state dict (the environment variable
    when no path is given); a missing file raises FileNotFoundError."""
    model, tree = inception
    torch.save(model.state_dict(), str(tmp_path / "inc.pth"))
    save_checkpoint(tree, str(tmp_path / "inc.ckpt"))
    monkeypatch.setenv("BBDM_FID_WEIGHTS", str(tmp_path / "inc.ckpt"))
    assert_state_dicts_equal(pfid.load_fid_params(str(tmp_path / "inc.pth")),
                             pfid.load_fid_params())
    lp = random_lpips("vgg")
    torch.save(lp.state_dict(), str(tmp_path / "lp.pth"))
    save_checkpoint(convert_lpips_state_dict(lp.state_dict(), "vgg"), str(tmp_path / "lp.ckpt"))
    monkeypatch.setenv("BBDM_LPIPS_WEIGHTS", str(tmp_path / "lp.ckpt"))
    assert_state_dicts_equal(plp.load_lpips_params(str(tmp_path / "lp.pth"), net="vgg"),
                             plp.load_lpips_params(net="vgg"))
    monkeypatch.delenv("BBDM_FID_WEIGHTS")
    monkeypatch.delenv("BBDM_LPIPS_WEIGHTS")
    with pytest.raises(FileNotFoundError, match="BBDM_FID_WEIGHTS"):
        pfid.load_fid_params(str(tmp_path / "absent.pth"))
    with pytest.raises(FileNotFoundError, match="BBDM_LPIPS_WEIGHTS"):
        plp.load_lpips_params()
