"""The colorization and inpainting datasets, ``cache_in_ram`` and the threaded
loader of the port (``bbdm_tpu_torch/data/``) against the JAX package's
(``bbdm_tpu/data/``), which reads with Pillow and OpenCV.

Bars as in ``test_torch_data.py::test_loader_batches_equal_the_jax_package``:
files at the image size load equal (1e-6), resized ones within one uint8
level (the JAX package resamples in float32, the port as Pillow does). The LAB
path and the inpainting boxes are exact at any size (the port's numpy
computes OpenCV's integer arithmetic; the boxes come from the same numpy
RandomState rule)."""

import os

import numpy as np
import pytest
from PIL import Image

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.data import DataLoader as JaxLoader
from bbdm_tpu.data import get_dataset as jax_get_dataset
from bbdm_tpu.data.base import clear_image_cache as jax_clear_cache
from bbdm_tpu_torch.data import DataLoader, base, get_dataset
from bbdm_tpu_torch.data.base import IMAGE_CACHE, cache_image, clear_image_cache
from tests.data.torch_images.make_fixtures import textured

FORMATS = ("png", "jpg", "bmp")  # file i is written as FORMATS[i % 3]


@pytest.fixture(autouse=True)
def fresh_caches():
    clear_image_cache()
    jax_clear_cache()
    yield
    clear_image_cache()
    jax_clear_cache()


def make_tree(root, file_size, counts=(3, 2, 4)):
    """<stage>/im<i>.<png|jpg|bmp>, textured RGB (every fourth one gray)."""
    rs = np.random.RandomState(file_size)
    for stage, n in zip(("train", "val", "test"), counts):
        os.makedirs(os.path.join(root, stage), exist_ok=True)
        for i in range(n):
            arr = textured(file_size, file_size, 3, seed=rs.randint(1 << 20))
            img = Image.fromarray(arr).convert("L" if i % 4 == 3 else "RGB")
            fmt = FORMATS[i % 3]
            img.save(os.path.join(root, stage, f"im{i}.{fmt}"), quality=90)
    return root


def config(root, kind, size, to_normal, flip=True, cache=False):
    return dict2namespace({"dataset_type": kind, "dataset_config": {
        "dataset_path": root, "image_size": size, "channels": 3, "to_normal": to_normal,
        "flip": flip, "cache_in_ram": cache}})


def jax_box(seed, index, size):
    """The JAX package's box rule (``bbdm_tpu/data/custom.py:183-191``)."""
    rng = np.random.RandomState((seed * 1_000_003 + index) % (2 ** 31))
    mask_w, mask_h = rng.randint(128, 181), rng.randint(128, 181)
    return rng.randint(0, size - mask_h + 1), rng.randint(0, size - mask_w + 1), mask_h, mask_w


def assert_batches_equal(mine, ref, atol, exact_keys=()):
    assert len(mine) == len(ref)
    for x, y in zip(mine, ref):
        assert x["x_name"] == y["x_name"] and x["x_cond_name"] == y["x_cond_name"]
        for key in ("x", "x_cond"):
            assert x[key].dtype == np.float32 and x[key].shape == y[key].shape
            if key in exact_keys:
                np.testing.assert_array_equal(x[key], y[key])
            else:
                np.testing.assert_allclose(x[key], y[key], rtol=0, atol=atol)


CASES = [("custom_colorization_RGB", 16, 16), ("custom_colorization_RGB", 23, 16),
         ("custom_colorization_LAB", 16, 16), ("custom_colorization_LAB", 23, 16),
         ("custom_colorization_LAB", 11, 16), ("custom_inpainting", 180, 180),
         ("custom_inpainting", 190, 180)]


@pytest.mark.parametrize("kind,file_size,size", CASES)
@pytest.mark.parametrize("to_normal", [True, False])
@pytest.mark.parametrize("workers", [0, 4])
def test_new_datasets_equal_the_jax_package(tmp_path, kind, file_size, size, to_normal, workers):
    """The flipped, shuffled train loader and the test loader over two epochs,
    through both packages' loaders (``set_epoch`` reseeds the boxes)."""
    root = make_tree(str(tmp_path), file_size)
    cfg = config(root, kind, size, to_normal)
    mine, ref = get_dataset(cfg), jax_get_dataset(cfg)
    resized = file_size != size
    atol = 2.0 / 255 + 1e-6 if resized else 1e-6
    lab = kind == "custom_colorization_LAB"
    for stage, shuffle in ((0, True), (2, False)):
        a = DataLoader(mine[stage], 2, shuffle=shuffle, seed=5, num_workers=workers)
        b = JaxLoader(ref[stage], 2, shuffle=shuffle, drop_last=True, seed=5, num_workers=0)
        assert len(a) == len(b) > 0
        for epoch in (0, 1):
            a.set_epoch(epoch), b.set_epoch(epoch)
            got, want = list(a), list(b)
            assert_batches_equal(got, want, atol, ("x", "x_cond") if lab else ())
            if kind == "custom_inpainting":
                idx = a._indices()
                for n, (x, y) in enumerate(zip(got, want)):
                    for r in range(2):
                        top, left, h, w = jax_box(5 + epoch, int(idx[2 * n + r]), size)
                        inside = np.zeros((size, size), bool)
                        inside[top:top + h, left:left + w] = True
                        for batch in (x, y):
                            assert (batch["x_cond"][r][inside] == 0).all()
                            np.testing.assert_array_equal(batch["x_cond"][r][~inside],
                                                          batch["x"][r][~inside])


@pytest.mark.parametrize("to_normal", [True, False])
def test_lab_reads_as_cv2_imread_equal_to_the_jax_package(tmp_path, to_normal):
    """EXIF-rotated JPEG and PNG files and a 16-bit gray PNG, which
    ``cv2.imread`` reads otherwise than Pillow: the LAB batches equal the JAX
    package's exactly."""
    from tests.data.torch_images.make_fixtures import png_bytes

    rs = np.random.RandomState(7)
    for stage in ("train", "val", "test"):
        os.makedirs(tmp_path / stage)
        for i, (fmt, orientation) in enumerate((("JPEG", 6), ("PNG", 8), ("JPEG", 3))):
            exif = Image.Exif()
            exif[0x0112] = orientation
            Image.fromarray(textured(19, 30, 3, seed=rs.randint(1 << 20))).save(
                tmp_path / stage / f"im{i}.{fmt.lower()}", format=fmt, quality=90,
                exif=exif.tobytes())
        (tmp_path / stage / "im3.png").write_bytes(
            png_bytes(rs.randint(0, 65536, (30, 19, 1)), 16, 0))
    cfg = config(str(tmp_path), "custom_colorization_LAB", 16, to_normal)
    for mine, ref in zip(get_dataset(cfg)[::2], jax_get_dataset(cfg)[::2]):
        a = DataLoader(mine, 2, shuffle=True, seed=3, num_workers=0)
        b = JaxLoader(ref, 2, shuffle=True, drop_last=True, seed=3, num_workers=0)
        assert_batches_equal(list(a), list(b), 0, ("x", "x_cond"))


def test_inpainting_boxes_follow_the_epoch_seed(tmp_path):
    root = make_tree(str(tmp_path), 180, counts=(2, 1, 1))
    ds = get_dataset(config(root, "custom_inpainting", 180, True))[0]
    loader = DataLoader(ds, 2, seed=11, num_workers=0)
    boxes = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        assert ds.mask_seed == 11 + epoch
        boxes.append([ds.box(i) for i in range(len(ds))])
        assert boxes[-1] == [jax_box(11 + epoch, i, 180) for i in range(len(ds))]
    assert boxes[0] != boxes[1]


@pytest.mark.parametrize("kind", ["custom_aligned", "custom_single", "custom_colorization_LAB"])
def test_threads_equal_one_thread_batch_for_batch(tmp_path, kind):
    root = str(tmp_path)
    if kind == "custom_aligned":  # <stage>/<side>/train/im<i>.*
        for stage in ("train", "val", "test"):
            for side in "AB":
                make_tree(os.path.join(root, stage, side), 21, counts=(7, 0, 0))
    else:
        make_tree(root, 21, counts=(7, 2, 2))
    train = get_dataset(config(root, kind, 16, True))[0]
    one = DataLoader(train, 3, shuffle=True, seed=2, num_workers=0)
    four = DataLoader(train, 3, shuffle=True, seed=2, num_workers=4)
    assert four.num_workers == 4 and DataLoader(train, 3).num_workers == min(8, os.cpu_count())
    for epoch in (0, 1):
        one.set_epoch(epoch), four.set_epoch(epoch)
        got, want = list(four), list(one)
        assert len(got) == len(want) == len(train) // 3
        for x, y in zip(got, want):
            assert x["x_name"] == y["x_name"]
            np.testing.assert_array_equal(x["x"], y["x"])
            np.testing.assert_array_equal(x["x_cond"], y["x_cond"])


def test_a_worker_error_reaches_the_caller(tmp_path):
    root = make_tree(str(tmp_path), 16)
    with open(os.path.join(root, "test", "im1.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff garbage")
    loader = DataLoader(get_dataset(config(root, "custom_colorization_RGB", 16, True))[2], 2,
                        num_workers=4)
    with pytest.raises(ValueError, match=r"im1\.jpg"):
        list(loader)


# ------------------------------------------------------------ cache_in_ram

def test_cache_hits_return_the_same_read_only_array(tmp_path, monkeypatch):
    """The second epoch of a cached loader decodes nothing: every item is the
    first epoch's array, read-only."""
    root = make_tree(str(tmp_path), 21)
    calls = []
    load = base._load_image
    monkeypatch.setattr(base, "_load_image", lambda *a: calls.append(a) or load(*a))
    ds = get_dataset(config(root, "custom_single", 16, True, cache=True))[0]
    first = [ds[i][0][0] for i in range(len(ds))]
    assert len(calls) == len(ds) == len(IMAGE_CACHE) == 6
    assert IMAGE_CACHE.nbytes == 6 * 16 * 16 * 3 * 4
    loader = DataLoader(ds, 2, shuffle=True, num_workers=4)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        assert len(list(loader)) == 3
    assert len(calls) == 6
    again = ds[4][0][0]
    assert again is first[4] and not again.flags.writeable
    with pytest.raises(ValueError):
        again[0, 0, 0] = 1.0


def test_a_tiny_cap_raises_naming_both_knobs(tmp_path, monkeypatch):
    root = make_tree(str(tmp_path), 16)
    monkeypatch.setenv("BBDM_CACHE_CAP_MB", "0.005")  # 5243 bytes: one 16^2 image fits
    clear_image_cache()
    ds = get_dataset(config(root, "custom_colorization_RGB", 16, True, cache=True))[2]
    ds[0]
    with pytest.raises(RuntimeError, match=r"dataset_config\.cache_in_ram.*BBDM_CACHE_CAP_MB"):
        ds[1]
    assert len(IMAGE_CACHE) == 1 and IMAGE_CACHE.nbytes == 16 * 16 * 3 * 4


def test_the_default_cap_is_a_quarter_of_memavailable_at_least_4096_mb(monkeypatch):
    monkeypatch.delenv("BBDM_CACHE_CAP_MB", raising=False)
    clear_image_cache()
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) for line in f if line.startswith("MemAvailable:"))
    want = max(4096.0, 0.25 * avail / 1024.0) * 2 ** 20
    assert abs(IMAGE_CACHE.cap_bytes() - want) <= 0.01 * want


def test_lab_and_rgb_entries_do_not_collide(tmp_path):
    root = make_tree(str(tmp_path), 16)
    rgb = get_dataset(config(root, "custom_colorization_RGB", 16, False, cache=True))[2]
    lab = get_dataset(config(root, "custom_colorization_LAB", 16, False, cache=True))[2]
    (x_rgb, _), _ = rgb[0]
    (x_lab, _), _ = lab[0]
    assert len(IMAGE_CACHE) == 2
    assert not np.array_equal(x_rgb, x_lab) and x_lab.max() > 1.0 >= x_rgb.max()
    assert rgb[0][0][0] is x_rgb and lab[0][0][0] is x_lab


def test_a_racing_producer_is_counted_once():
    """Two threads missing on one key: both produce, one entry lands."""
    import threading

    barrier = threading.Barrier(2)
    out = []

    def produce():
        barrier.wait()
        return np.zeros(10, np.float32)

    threads = [threading.Thread(target=lambda: out.append(cache_image("k", produce)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert out[0] is out[1] and len(IMAGE_CACHE) == 1 and IMAGE_CACHE.nbytes == 40
