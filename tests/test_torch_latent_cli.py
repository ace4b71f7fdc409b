"""``main_torch.py --sample_to_eval`` on a cut LBBDM-f8-shaped config against the
JAX package's ``main.py``, both on the CPU: the tiny f8-shaped LBBDM of
``tests/test_torch_latent_configs.py`` (a 4-level VQGAN with attention at its
lowest level, z 4, a 3-stage SpatialRescaler context; a one-level UNet, since
the JAX runner initialises its model op by op), eta 0 (no draw reaches the
output), one checkpoint and one PNG dataset: the same result tree, each PNG
within one uint8 level."""

import os

import numpy as np
import yaml
from test_torch_cli import _NoAliases, files, run_jax
from test_torch_latent_configs import seeded, tiny

import main_torch
from bbdm_tpu.checkpoints.io import save_checkpoint
from bbdm_tpu_torch.utils.images import read_png, write_png


def test_cli_sample_to_eval_on_a_cut_f8_config_matches_jax_main(tmp_path, monkeypatch):
    d = tiny("f8")
    d["BB"]["params"]["eta"] = 0.0
    d["BB"]["params"]["UNetParams"].update(channel_mult=(1,), attention_resolutions=[])
    _, params = seeded(d, 5)
    rs = np.random.RandomState(0)
    for stage, n in (("train", 2), ("val", 2), ("test", 4)):
        for side in "AB":
            os.makedirs(tmp_path / "data" / stage / side)
            for i in range(n):
                write_png(str(tmp_path / "data" / stage / side / f"p{i}.png"),
                          rs.randint(0, 256, (32, 32, 3)).astype(np.uint8))
    save_checkpoint({"model": params, "ema": params, "step": 4, "epoch": 1},
                    str(tmp_path / "m.ckpt"))
    save_checkpoint({"vqgan": params["vqgan"]}, str(tmp_path / "vq.ckpt"))
    d["VQGAN"]["params"]["ckpt_path"] = str(tmp_path / "vq.ckpt")
    d["EMA"] = {"use_ema": False}
    cfg = {"runner": "BBDMRunner",
           "training": {"n_epochs": 1, "n_steps": 1, "save_interval": 1, "sample_interval": 1,
                        "validation_interval": 1, "accumulate_grad_batches": 1},
           "testing": {"clip_denoised": False, "sample_num": 1},
           "data": {"dataset_name": "tiny", "dataset_type": "custom_aligned",
                    "dataset_config": {"dataset_path": str(tmp_path / "data"), "image_size": 32,
                                       "channels": 3, "to_normal": True, "flip": True},
                    "train": {"batch_size": 2, "shuffle": True},
                    "val": {"batch_size": 2, "shuffle": True}, "test": {"batch_size": 2}},
           "model": d}
    with open(tmp_path / "f8.yaml", "w") as f:
        yaml.dump(cfg, f, Dumper=_NoAliases)
    argv = ["-c", str(tmp_path / "f8.yaml"), "--resume_model", str(tmp_path / "m.ckpt"),
            "--gpu_ids", "-1", "--sample_to_eval"]
    run_jax(monkeypatch, argv + ["-r", str(tmp_path / "jax")])
    main_torch.main(argv + ["-r", str(tmp_path / "port")])
    got, want = files(tmp_path / "port"), files(tmp_path / "jax")
    assert got == want
    pngs = [p for p in got if p.endswith(".png")]
    assert len(pngs) == 12  # 4 conditions, 4 ground truths, 4 samples
    for p in pngs:
        a, b = read_png(str(tmp_path / "port" / p)), read_png(str(tmp_path / "jax" / p))
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a.astype(int) - b).max() <= 1, p
