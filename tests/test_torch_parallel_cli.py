"""``main_torch.py`` as two nodes of one run on the CPU (``BBDM_MULTIHOST=1``,
``--gpu_ids -1``: one gloo rank per node, each its own process) against one
process, through ``--train`` and then ``--sample_to_eval``.

``data.*.batch_size`` is per node, and node k takes every second index from
k (the JAX loader's shards). With a batch of 1 per node, global batch i is
then indices 2i and 2i + 1 in that order: the batch of 2 of the one-process
run, row for row, so both runs take the same draws for the same rows.

Bars: the checkpoint's counters and file names equal; the model and EMA
weights and Adam's moments with the bars of ``test_torch_train_step.py``
(lr 1e-3); the latent statistics 1e-5; the sampled PNGs within 1 uint8 code.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch_parallel_worker as worker
from test_torch_parallel import free_port, one_thread, png_tree, write_pairs
from test_torch_train_step import assert_trees_close, assert_weights_close

import main_torch
from bbdm_tpu_torch.checkpoints.io import load_checkpoint
from bbdm_tpu_torch.config import save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, LR = 2, 1e-3


def config(root, batch):
    cfg = worker.lbbdm_runner_config(os.path.join(root, "data"), None, n_epochs=2,
                                     sample_interval=100)
    del cfg.args
    for split in ("train", "val", "test"):
        cfg.data[split].batch_size = batch
    path = os.path.join(root, f"batch{batch}.yaml")
    save_config(cfg, path)
    return path


def nodes(argv, timeout=300):
    """``main_torch.py argv`` as ``NODES`` nodes of one run; raises unless all succeed."""
    env = {**os.environ, "BBDM_MULTIHOST": "1", "BBDM_NUM_PROCESSES": str(NODES),
           "BBDM_COORDINATOR": f"127.0.0.1:{free_port()}", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "main_torch.py", *argv], cwd=REPO,
                              env={**env, "BBDM_PROCESS_ID": str(k)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for k in range(NODES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nodes"))
    write_pairs(os.path.join(root, "data"))
    one_cfg, node_cfg = config(root, NODES), config(root, 1)
    common = ["--gpu_ids", "-1", "-s", "1234"]
    sample = ["--sample_to_eval", "--resume_model",
              os.path.join(root, "one", "tiny", "tiny-lbbdm", "checkpoint", "last_model.ckpt")]
    with one_thread():
        main_torch.main(["-c", one_cfg, "--train", "-r", os.path.join(root, "one"), *common])
        outs = nodes(["-c", node_cfg, "--train", "-r", os.path.join(root, "nodes"), *common])
        main_torch.main(["-c", one_cfg, *sample, "-r", os.path.join(root, "s-one"), *common])
        nodes(["-c", node_cfg, *sample, "-r", os.path.join(root, "s-nodes"), *common])
    return root, outs


def test_two_nodes_write_the_checkpoint_one_process_writes(runs):
    root, outs = runs
    ckpt = os.path.join("tiny", "tiny-lbbdm", "checkpoint")
    one, two = os.path.join(root, "one", ckpt), os.path.join(root, "nodes", ckpt)
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    assert "save training results" in outs[0] and "save training results" not in outs[1]
    a, b = load_checkpoint(os.path.join(two, "last_model.ckpt")), \
        load_checkpoint(os.path.join(one, "last_model.ckpt"))
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (4, 2)
    assert sorted(a) == sorted(b)
    for tree in ("model", "ema"):
        assert_weights_close(a[tree], b[tree], LR, 2 * LR * b["step"])
    for k in ("ori_latent_mean", "ori_latent_std", "cond_latent_mean", "cond_latent_std"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
    oa, ob = (load_checkpoint(os.path.join(d, "last_optim_sche.ckpt")) for d in (two, one))
    assert_trees_close(oa["optimizer"][0], ob["optimizer"][0], 1e-4, 2e-4, "optimizer")
    assert_trees_close(oa["scheduler"][0], ob["scheduler"][0], 1e-4, 2e-4, "scheduler")


def test_two_nodes_sample_what_one_process_samples(runs):
    root, _ = runs
    base = os.path.join("tiny", "tiny-lbbdm", "sample_to_eval")
    one = png_tree(os.path.join(root, "s-one", base))
    two = png_tree(os.path.join(root, "s-nodes", base))
    assert sorted(two) == sorted(one) and len(one) == 4 * (2 + 2)
    for k in one:
        assert np.abs(two[k].astype(int) - one[k]).max() <= 1, k
