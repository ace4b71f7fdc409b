"""The benchmark's own work counts against the program's as they stand: the
frozen FLOP arithmetic and the kernels' calls from the reference's meta walk."""

import json
import os
from collections import Counter

import pytest

from benchmark import flops
from benchmark.roofline import bound_s, kernel_calls

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = ["lbbdm_f4", "lbbdm_f16"]


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_equal_the_programs(name):
    from bbdm_tpu_torch.config import dict2namespace
    from bbdm_tpu_torch.utils import flops as program

    d = _config(name)
    m = dict2namespace(d).model
    assert flops.unet_forward(d["model"]["BB"]["params"]["UNetParams"]) == \
        program.unet_forward_flops(m.BB.params.UNetParams)
    for enc, dec in ((True, True), (True, False), (False, True)):
        assert flops.vqgan(d["model"]["VQGAN"]["params"], encode=enc, decode=dec) == \
            program.vqgan_flops(m.VQGAN.params, encode=enc, decode=dec)
    assert flops.sample_batch(d["model"], 1, 1) == pytest.approx(
        program.sampling_flops_per_image(m), rel=1e-12)
    assert flops.train_image(d["model"]) == program.training_flops_per_image(m)


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_calls_equal_the_programs_walk(name):
    import chip_smoke
    from bbdm_tpu_torch.config import dict2namespace

    d = _config(name)
    mine = kernel_calls(d["model"], 8)
    theirs = chip_smoke.kernel_calls(dict2namespace(d).model, 8)
    short = {"group_norm": "K1", "upsample_conv": "K2", "flash_attention": "K3"}

    def as_theirs(calls, training=False):
        out = Counter()
        for (k, key), n in calls.items():
            if not (training and k == "upsample_conv"):
                out[short[k], key[:4] if k == "group_norm" else key] += n
        return out

    for part in ("encoder", "decoder", "unet"):
        assert as_theirs(mine[part]) == theirs[part], part
    assert as_theirs(mine["unet"], training=True) == theirs["unet_train"]


def test_bounds_of_known_shapes():
    # PERF.md's kernel table: K1 [8,1024,32,32] FiLM 10.0 us (bytes), K2
    # [8,512,64,64]->512 277.9 us (operations), K3 [8,1,4096,512] 277.9 us
    assert bound_s("group_norm", (8, 1024, 32, 32, True), 2) * 1e6 == pytest.approx(10.03, abs=0.01)
    assert bound_s("upsample_conv", (8, 512, 64, 64, 512), 2) * 1e6 == pytest.approx(277.9, abs=0.1)
    assert bound_s("flash_attention", (8, 1, 4096, 512, 4096), 2) * 1e6 == \
        pytest.approx(277.9, abs=0.1)
