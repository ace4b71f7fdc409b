"""``training.device_data_cache`` in the port (``data/device_cache.py``, the
runners' wiring) against the JAX package's ``DeviceCachedLoader`` and the
port's own host loader, on the CPU.

* The same dataset object through both packages' caches (JAX on a one-device
  CPU mesh): equal batches, names and order over two epochs, in float32 and
  in bfloat16 (each value rounded once, to nearest even, at storage), bit for
  bit.
* The cached batches equal the host loader's as the runner puts them on the
  device (``_put_batch``: NCHW-contiguous float32), bit for bit and layout
  included, over two epochs.
* The identity stream is stored once; a dataset with per-epoch draws, and a
  set above ``BBDM_DEVICE_CACHE_MB``, are refused; several nodes fall back
  to the host loader with JAX's logged reason; a loader built for
  ``num_workers`` 0 has its dataset read from one thread only.
* Through ``BBDMRunner``: the first train step's loss is exactly the one
  without the cache; ``test()`` (``sample_to_eval``) and
  ``_build_loaders(for_training=False)`` build no cache; an LBBDM
  ``train()`` with the latent-statistics pass reads each image once.

The two-rank case runs in ``tests/test_torch_parallel.py``.
"""

import os
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from bbdm_tpu.data import DataLoader as JaxLoader
from bbdm_tpu.data.device_cache import DeviceCachedLoader as JaxCachedLoader
from bbdm_tpu.parallel import make_mesh
from bbdm_tpu_torch.config import dict2namespace
from bbdm_tpu_torch.data import DataLoader, base, get_dataset
from bbdm_tpu_torch.data import device_cache
from bbdm_tpu_torch.data.device_cache import DeviceCachedLoader, maybe_device_cache
from bbdm_tpu_torch.runners.bbdm import BBDMRunner
from tests.test_torch_data import data_config, make_dataset
from tests.test_torch_parallel import write_pairs
from tests.torch_parallel_worker import lbbdm_runner_config

ONE_NODE = SimpleNamespace(nodes=1)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Arrays:
    """``n`` seeded float32 items (values that bfloat16 rounds), the condition
    the item itself under ``identity``; records the threads that read it."""

    def __init__(self, n, size=8, identity=False, seed=0):
        rs = np.random.RandomState(seed)
        self.x = rs.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
        self.c = rs.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
        self.identity = identity
        self.threads = set()

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        self.threads.add(threading.get_ident())
        x = (self.x[i], f"x{i}")
        return (x, x) if self.identity else (x, (self.c[i], f"c{i}"))


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2).contiguous()


def assert_same_tensor(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batches_equal_the_jax_cache(dtype):
    ds = Arrays(10)
    jax_loader = JaxCachedLoader(JaxLoader(ds, 4, shuffle=True, drop_last=True, seed=7,
                                           num_workers=0),
                                 make_mesh(jax.devices()[:1]), dtype=dtype)
    port = DeviceCachedLoader(DataLoader(ds, 4, shuffle=True, seed=7, num_workers=0), "cpu",
                              dtype=dtype)
    assert port.device_bytes == jax_loader.device_bytes
    for epoch in (0, 1):
        jax_loader.set_epoch(epoch)
        port.set_epoch(epoch)
        want, got = list(jax_loader), list(port)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["x_name"] == w["x_name"] and g["x_cond_name"] == w["x_cond_name"]
            for key in ("x", "x_cond"):
                assert g[key].dtype == torch.float32 and g[key].is_contiguous()
                np.testing.assert_array_equal(g[key].permute(0, 2, 3, 1).numpy(),
                                              np.asarray(w[key]))
    if dtype == "bfloat16":  # rounded: not the host values
        batch = next(iter(port))
        assert not torch.equal(batch["x"], nchw(ds.x[[int(n[1:]) for n in batch["x_name"]]]))


def test_batches_equal_the_host_loader_as_the_runner_puts_them(tmp_path):
    make_dataset(str(tmp_path))
    ds = get_dataset(data_config(str(tmp_path)))[2]
    host = DataLoader(ds, 2, shuffle=True, seed=3)
    cached = DeviceCachedLoader(DataLoader(ds, 2, shuffle=True, seed=3), "cpu")
    for epoch in (0, 1):
        host.set_epoch(epoch)
        cached.set_epoch(epoch)
        batches = list(zip(host, cached))
        assert len(batches) == len(host) == len(cached) == 2
        for h, c in batches:
            assert h["x_name"] == c["x_name"] and h["x_cond_name"] == c["x_cond_name"]
            assert_same_tensor(c["x"], nchw(h["x"]))
            assert_same_tensor(c["x_cond"], nchw(h["x_cond"]))
    assert cached.dataset is ds and cached.device_bytes == 2 * 5 * 3 * 16 * 16 * 4


def test_the_identity_stream_is_stored_once():
    ds = Arrays(4, identity=True)
    cached = DeviceCachedLoader(DataLoader(ds, 2), "cpu")
    assert cached.resident.cond is cached.resident.x
    assert cached.device_bytes == 4 * 3 * 8 * 8 * 4
    batch = next(iter(cached))
    assert torch.equal(batch["x"], batch["x_cond"]) and batch["x_name"] == batch["x_cond_name"]


def test_a_condition_stream_that_starts_as_the_identity_is_stored_whole():
    class Mixed(Arrays):
        def __getitem__(self, i):
            (x, name), cond = super().__getitem__(i)
            return ((x, name), (x, name)) if i < 70 else ((x, name), cond)

    ds = Mixed(72, size=2)  # past the first chunk of 64 items
    cached = DeviceCachedLoader(DataLoader(ds, 8, num_workers=0), "cpu")
    assert cached.resident.cond is not cached.resident.x
    want = np.concatenate([ds.x[:70], ds.c[70:]])
    np.testing.assert_array_equal(cached.resident.cond.permute(0, 2, 3, 1).numpy(), want)


def test_a_dataset_with_per_epoch_draws_is_refused():
    ds = Arrays(4)
    ds.set_epoch_seed = lambda seed: None
    with pytest.raises(ValueError, match="per-epoch randomness"):
        DeviceCachedLoader(DataLoader(ds, 2), "cpu")


def test_the_size_cap_raises_naming_the_size_and_the_knob(monkeypatch):
    monkeypatch.setenv("BBDM_DEVICE_CACHE_MB", "0.001")
    with pytest.raises(ValueError, match=r"use 0 MB .*> 0 MB cap.*BBDM_DEVICE_CACHE_MB"):
        DeviceCachedLoader(DataLoader(Arrays(4), 2), "cpu")


def test_several_nodes_fall_back_to_the_host_loader_with_the_reason():
    loader, logs = DataLoader(Arrays(4), 2), []
    on = dict2namespace({"device_data_cache": True})
    assert maybe_device_cache(loader, on, SimpleNamespace(nodes=2), "cpu", logs.append) \
        is loader
    assert len(logs) == 1 and "multi-host mesh -> host loader" in logs[0]
    off = dict2namespace({"device_data_cache": False})
    assert maybe_device_cache(loader, off, ONE_NODE, "cpu", logs.append) is loader
    cached = maybe_device_cache(loader, on, ONE_NODE, "cpu", logs.append)
    assert isinstance(cached, DeviceCachedLoader) and len(logs) == 2
    assert logs[1].startswith("device_data_cache: 4 items (0 MB float32) resident on device")


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_the_decode_keeps_to_the_loaders_threads(workers):
    ds = Arrays(70, size=2)
    DeviceCachedLoader(DataLoader(ds, 2, num_workers=workers), "cpu")
    if workers <= 1:
        assert ds.threads == {threading.get_ident()}
    else:
        assert threading.get_ident() not in ds.threads and 1 <= len(ds.threads) <= workers


# ------------------------------------------------------------------ runners

@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cache"))
    write_pairs(os.path.join(root, "data"), n=8)
    return root


def runner(root, name, train=True, **training):
    cfg = lbbdm_runner_config(os.path.join(root, "data"), os.path.join(root, name),
                              **training)
    if not train:
        cfg.args.train, cfg.args.sample_to_eval = False, True
    return BBDMRunner(cfg, device="cpu")


def test_the_first_train_step_is_the_same_with_the_cache(pairs):
    """The latent statistics (gathered from the resident copy) and ``_put_batch``
    of the cached batch are the host path's, bit for bit, and so is the first
    train step's loss (the same seeds)."""
    out, stats = {}, {}
    for flag in (False, True):
        r = runner(pairs, f"first-{flag}", device_data_cache=flag)
        stats[flag] = r.latent_stats
        loader = r._build_loaders()[0]
        assert isinstance(loader, DeviceCachedLoader) == flag
        loader.set_epoch(0)
        batch = next(iter(loader))
        x, y = r._put_batch(batch)
        metrics = r.build_train_step()(r.state, x, y, torch.Generator().manual_seed(3))
        out[flag] = (x, y, batch["x_name"], float(metrics["loss"]))
    (hx, hy, hn, hloss), (cx, cy, cn, closs) = out[False], out[True]
    assert hn == cn
    assert_same_tensor(cx, hx)
    assert_same_tensor(cy, hy)
    assert closs == hloss
    assert all(torch.equal(stats[True][k], stats[False][k]) for k in stats[False])


def test_test_and_sample_to_eval_build_no_cache(pairs, monkeypatch):
    r = runner(pairs, "no-cache-train", device_data_cache=True)
    assert all(type(lo) is DataLoader for lo in r._build_loaders(for_training=False))
    assert all(isinstance(lo, DeviceCachedLoader) for lo in r._build_loaders()[:2])

    def refuse(*a, **kw):
        raise AssertionError("a device cache was built")

    monkeypatch.setattr(device_cache, "Resident", refuse)
    s = runner(pairs, "no-cache-s2e", train=False, device_data_cache=True)
    s.test()
    assert os.listdir(os.path.join(s.config.result.sample_to_eval_path, "ground_truth"))


def test_an_lbbdm_train_reads_each_image_once(pairs, monkeypatch):
    """The latent-statistics pass (in the runner's construction) and two
    epochs of ``train()`` (validation, sample grids and checkpoints included)
    under the cache: every train and val image is decoded once, no test image."""
    reads = []
    getitem = base.ImagePathDataset.__getitem__

    def counted(self, index):
        reads.append(self.image_paths[index % len(self.image_paths)])
        return getitem(self, index)

    monkeypatch.setattr(base.ImagePathDataset, "__getitem__", counted)
    logs = []
    monkeypatch.setattr(BBDMRunner, "logger", lambda self, msg: logs.append(str(msg)))
    r = runner(pairs, "once", device_data_cache=True, n_epochs=2)
    assert r.latent_stats is not None
    r.train()
    assert r.global_step == 4 and not r._resident
    data = os.path.join(pairs, "data")
    want = sorted(os.path.join(data, stage, side, f"p{i}.png")
                  for stage in ("train", "val") for side in "AB" for i in range(8))
    assert sorted(reads) == want
    assert sum("resident on device" in m for m in logs) == 2  # train, val
