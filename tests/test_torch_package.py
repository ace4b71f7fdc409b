"""The port's jax-free pieces against the JAX package: schedules, the config
twin, the weight converter, the PNG writer, and an import with jax, PyYAML and
Pillow absent."""

import os
import subprocess
import sys

import numpy as np
import pytest

from bbdm_tpu.config import load_config
from bbdm_tpu.models import schedules as js
from bbdm_tpu_torch.checkpoints.from_jax import state_dict_from_jax
from bbdm_tpu_torch.config import lbbdm_f4_config
from bbdm_tpu_torch.models import layers as tl
from bbdm_tpu_torch.models import schedules as ts
from bbdm_tpu_torch.utils.images import encode_png, to_uint8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("T,mt_type,skip,sample_type,S,eta", [
    (1000, "linear", True, "linear", 200, 1.0),
    (1000, "sin", True, "cosine", 50, 0.5),
    (50, "linear", False, "linear", 6, 0.0),
])
def test_schedules_equal_jax_package(T, mt_type, skip, sample_type, S, eta):
    a = js.make_bridge_schedule(T, mt_type, 1.0)
    b = ts.make_bridge_schedule(T, mt_type, 1.0)
    for f in ("m_t", "m_tminus", "variance_t", "variance_tminus", "variance_t_tminus",
              "posterior_variance_t"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    steps = js.make_sampling_steps(T, skip, sample_type, S)
    np.testing.assert_array_equal(steps, ts.make_sampling_steps(T, skip, sample_type, S))
    ca = js.make_sampler_coeffs(T, mt_type, 1.0, steps, eta)
    cb = ts.make_sampler_coeffs(T, mt_type, 1.0, steps, eta)
    for f in ("steps", "a_xt", "a_x0", "a_y", "sigma", "m_t", "sigma_fwd"):
        np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
        assert getattr(ca, f).dtype == getattr(cb, f).dtype


def test_config_twin_equals_template():
    ref = load_config(os.path.join(REPO, "configs", "Template-LBBDM-f4.yaml")).to_dict()
    assert lbbdm_f4_config().to_dict() == ref


def test_from_jax_raises_on_missing_and_unused_keys():
    block = tl.ResBlock(32, 64, 128, use_scale_shift_norm=True)
    rs = np.random.RandomState(0)
    tree = {}
    for name, p in block.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        shape = tuple(p.shape)
        if leaf == "weight" and p.ndim == 4:
            leaf, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
        elif leaf == "weight" and p.ndim == 2:
            leaf, shape = "kernel", shape[::-1]
        elif leaf == "weight":
            leaf = "scale"
        tree.setdefault(mod, {})[leaf] = rs.randn(*shape).astype(np.float32)
    sd = state_dict_from_jax(tree, block)
    k = tree["in_conv"]["kernel"]
    np.testing.assert_array_equal(sd["in_conv.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["emb_proj.weight"].numpy(), tree["emb_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["in_norm.weight"].numpy(), tree["in_norm"]["scale"])
    block.load_state_dict(sd)

    missing = {m: dict(v) for m, v in tree.items()}
    del missing["skip"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax(missing, block)
    unused = dict(tree, extra={"kernel": np.zeros((3, 3), np.float32)})
    with pytest.raises(KeyError, match="unused"):
        state_dict_from_jax(unused, block)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trips_through_pillow(tmp_path, channels):
    import io

    from PIL import Image

    from bbdm_tpu.utils.images import to_uint8 as jax_to_uint8

    rs = np.random.RandomState(channels)
    img = rs.uniform(-1.2, 1.2, (5, 7, channels)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(img), jax_to_uint8(img))
    u8 = to_uint8(img)
    decoded = np.asarray(Image.open(io.BytesIO(encode_png(u8))))
    np.testing.assert_array_equal(decoded, u8[..., 0] if channels == 1 else u8)


def test_import_needs_no_jax_yaml_or_pillow(tmp_path):
    """The package (every module, ``evaluation/``, ``native/`` and ``tools/``
    included), main_torch.py, bench_torch.py, preprocess_and_evaluation_torch.py
    and chip_smoke.py import where jax, flax, optax, yaml, PIL, cv2, msgpack and
    transformers are absent, and import no
    triton, nothing of ``bbdm_tpu`` or ``tests`` and build nothing at import
    time: no compiler runs (``CXX`` names a file that records a call) and the
    host library is not loaded."""
    marker = tmp_path / "called"
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    cxx.chmod(0o755)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'PIL', 'cv2', 'msgpack',\n"
        "          'transformers'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, bbdm_tpu_torch\n"
        "for mod in pkgutil.walk_packages(bbdm_tpu_torch.__path__, 'bbdm_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "assert 'bbdm_tpu_torch.data.loader' in sys.modules\n"
        "assert 'bbdm_tpu_torch.training.step' in sys.modules\n"
        "assert 'bbdm_tpu_torch.evaluation.lpips' in sys.modules\n"
        "assert 'bbdm_tpu_torch.evaluation.cli' in sys.modules\n"
        "assert 'bbdm_tpu_torch.data.device_cache' in sys.modules\n"
        "for t in ('bench', 'bench_train', 'convert_checkpoint', 'vqgan_recon',\n"
        "          'sampler_sweep', 'synthetic', 'read_tboard', 'pixel_demo',\n"
        "          'stochastic_demo', 'chain_demo', 'random_inception', 'random_lpips',\n"
        "          'run_parity'):\n"
        "    assert 'bbdm_tpu_torch.tools.' + t in sys.modules\n"
        "assert 'bbdm_tpu_torch.utils.flops' in sys.modules\n"
        "import main_torch\n"
        "import bench_torch\n"
        "import preprocess_and_evaluation_torch\n"
        "import chip_smoke\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'bbdm_tpu_torch.native.fastimage' in sys.modules\n"
        "from bbdm_tpu_torch.native import build\n"
        "assert build._lib is None\n"
        "assert not any(m.split('.')[0] in ('bbdm_tpu', 'tests') for m in sys.modules)\n"
        "import torch\n"
        "assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, CXX=str(cxx))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert not marker.exists()
