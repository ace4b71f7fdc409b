"""The port's YAML reader and writer and its CLI overrides against the JAX
package (PyYAML's ``FullLoader``)."""

import argparse
import glob
import math
import os
from types import SimpleNamespace

import pytest
import yaml

from bbdm_tpu.config import load_config as jax_load_config
from bbdm_tpu_torch.config import (
    ConfigSyntaxError,
    apply_cli_overrides,
    device_from_gpu_ids,
    dict2namespace,
    load_config,
    parse_yaml,
    save_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def untuple(x):
    if isinstance(x, dict):
        return {k: untuple(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [untuple(v) for v in x]
    return x


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_equals_pyyaml(path):
    """Every config of the repo reads to the same tree, types included (tuples
    stay tuples, ``1.e-4`` is a float)."""
    mine = load_config(os.path.join(REPO, path)).to_dict()
    ref = jax_load_config(os.path.join(REPO, path)).to_dict()
    assert mine == ref

    def types(t):
        if isinstance(t, dict):
            return {k: types(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, [types(v) for v in t])
        return type(t).__name__

    assert types(mine) == types(ref)


@pytest.mark.parametrize("text", [
    "1.e-4", "1e-4", "1.0e-4", "1.0e4", "5.e-7", "0.000", "1_000", ".5", "+1", "-0x1F",
    "017", "0b11", "08", "-0", "yes", "Off", "TRUE", "~", "null", "", ".inf", "-.Inf",
    "'it''s' # c", '"a\\"b"', "x # comment", "a#b", "[1, 'a', 2.]", "[ ]", "{}",
    "torch.nn.Identity", "True   ",
])
def test_scalars_resolve_as_pyyaml(text):
    src = f"a: {text}\n"
    mine, ref = parse_yaml(src)["a"], yaml.load(src, Loader=yaml.FullLoader)["a"]
    if isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(mine)
    else:
        assert mine == ref and type(mine) is type(ref)


@pytest.mark.parametrize("src,line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a:\n  b: *alias\n", 2),
    ("a: {b: 1}\n", 1),
    ("a:\n  - b: 1\n", 2),
    ("a: 1\nb: 1:30\n", 2),
    ("a: 2001-12-14\n", 1),
    ("a: |\n  text\n", 1),
    ("a: 1\n   b: 2\n", 2),
    ("a:\n  b: !!str 1\n", 2),
    ("a: 1\n---\nb: 2\n", 2),
    ("a: 1\nyes: 2\n", 2),
])
def test_unsupported_construct_raises_with_line(tmp_path, src, line):
    path = tmp_path / "bad.yaml"
    path.write_text(src)
    with pytest.raises(ConfigSyntaxError, match=rf"{path}: line {line}:"):
        load_config(str(path))


@pytest.mark.parametrize("path", [p for p in CONFIGS if "Template" in p])
def test_saved_config_reads_back_through_pyyaml(tmp_path, path):
    cfg = load_config(os.path.join(REPO, path))
    cfg.args = argparse.Namespace(seed=3)  # written as its str, as the JAX package does
    cfg.model.extra = {"lr": 5e-7, "big": 1e16, "neg": -2, "none": None, "empty": [],
                       "text": "it's: #1", "word": "yes", "nested": {}}
    out = tmp_path / "config.yaml"
    save_config(cfg, str(out))
    ref = untuple(cfg.to_dict())
    ref["args"] = str(cfg.args)
    with open(out) as f:
        assert yaml.load(f, Loader=yaml.FullLoader) == ref
    assert load_config(str(out)).to_dict() == ref


@pytest.mark.parametrize("gpu_ids,device", [("-1", "cpu"), ("0", "cuda:0"), ("3", "cuda:3")])
def test_gpu_ids_name_one_device(gpu_ids, device):
    assert device_from_gpu_ids(gpu_ids) == device


@pytest.mark.parametrize("gpu_ids", ["0,1", "0,2,3"])
def test_several_gpu_ids_raise(gpu_ids):
    with pytest.raises(NotImplementedError, match="data-parallel"):
        device_from_gpu_ids(gpu_ids)


def test_cli_overrides_follow_the_jax_package():
    from bbdm_tpu.config import apply_cli_overrides as jax_apply

    def args():
        return SimpleNamespace(resume_model="m.ckpt", resume_optim="o.ckpt", max_epoch=3,
                               max_steps=7, gpu_ids="-1")

    base = {"model": {"model_name": "x"}, "training": {"n_epochs": 1, "n_steps": 2}}
    mine = apply_cli_overrides(dict2namespace(base), args())
    ref = jax_apply(dict2namespace(base), args())
    assert {k: v for k, v in mine.to_dict().items() if k != "args"} == \
        {k: v for k, v in ref.to_dict().items() if k != "args"}
    assert mine.args.gpu_ids == "-1"
