"""Shared pieces of the benchmark's tests: the repository root on the path and
a tiny LBBDM configuration (the structure of the templates at a few thousand
parameters) for the CPU."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "runner": "BBDMRunner",
    "training": {"accumulate_grad_batches": 2},
    "testing": {"clip_denoised": False, "sample_num": 2},
    "data": {"dataset_name": "tiny", "dataset_type": "custom_aligned",
             "dataset_config": {"dataset_path": "unused", "image_size": 32, "channels": 3,
                                "to_normal": True, "flip": False},
             "train": {"batch_size": 4, "shuffle": True}, "val": {"batch_size": 4},
             "test": {"batch_size": 4}},
    "model": {
        "model_name": "tiny", "model_type": "LBBDM", "latent_before_quant_conv": False,
        "normalize_latent": False, "only_load_latent_mean_std": False,
        "mixed_precision": False, "init_scheme": "reference",
        "EMA": {"use_ema": True, "ema_decay": 0.995, "update_ema_interval": 2,
                "start_ema_step": 4},
        "CondStageParams": {"n_stages": 2, "in_channels": 3, "out_channels": 3},
        "VQGAN": {"params": {"ckpt_path": None, "embed_dim": 3, "n_embed": 64,
                             "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 32,
                                          "in_channels": 3, "out_ch": 3, "ch": 32,
                                          "ch_mult": [1, 2], "num_res_blocks": 1,
                                          "attn_resolutions": [16], "dropout": 0.0}}},
        "BB": {"optimizer": {"weight_decay": 0.0, "optimizer": "Adam", "lr": 1e-4, "beta1": 0.9},
               "lr_scheduler": {"factor": 0.5, "patience": 100, "threshold": 1e-4,
                                "cooldown": 100, "min_lr": 5e-7},
               "params": {"mt_type": "linear", "objective": "grad", "loss_type": "l1",
                          "skip_sample": True, "sample_type": "linear", "sample_step": 5,
                          "num_timesteps": 50, "eta": 1.0, "max_var": 1.0,
                          "UNetParams": {"image_size": 16, "in_channels": 3,
                                         "model_channels": 32, "out_channels": 3,
                                         "num_res_blocks": 1, "attention_resolutions": [2],
                                         "channel_mult": [1, 2], "conv_resample": True,
                                         "dims": 2, "num_heads": 4, "num_head_channels": 16,
                                         "use_scale_shift_norm": True, "resblock_updown": True,
                                         "use_spatial_transformer": False, "context_dim": None,
                                         "condition_key": "nocond"}}}}}


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One intra-op thread a test process: the tests run in several workers."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def tiny():
    return copy.deepcopy(TINY)


@pytest.fixture
def card():
    """The CUDA card, decided here and not at import; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's hand-written kernels)")
    return torch.device("cuda", 0)
