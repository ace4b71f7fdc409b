"""The port's PNG reader, Pillow-compatible resize, datasets and loader against
Pillow and the JAX package's data layer."""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.data import DataLoader as JaxLoader
from bbdm_tpu.data import get_dataset as jax_get_dataset
from bbdm_tpu_torch.data import DataLoader, get_dataset
from bbdm_tpu_torch.data.base import resize_bilinear
from bbdm_tpu_torch.utils.images import (
    decode_png,
    encode_png,
    get_image_grid,
    read_png,
    to_rgb,
    write_png,
)

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def textured(h, w, c, seed):
    """Smooth gradients plus noise: Pillow's encoder picks a mix of row filters."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.sin(yy / 7.0)[..., None] * 90 + xx[..., None] * 0.7 + np.arange(c) * 40
    return np.clip(base + 60 + rs.randint(0, 25, (h, w, c)), 0, 255).astype(np.uint8)


def pillow_png(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(buf, format="PNG")
    return buf.getvalue()


def row_filters(data):
    """The filter byte of every row of an 8-bit PNG."""
    pos, idat, W, H, C = 8, [], 0, 0, 0
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if kind == b"IHDR":
            W, H, _, color = struct.unpack(">IIBB", data[pos + 8:pos + 18])
            C = {0: 1, 4: 2, 2: 3, 6: 4}[color]
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return set(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[::W * C + 1].tolist())


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reader_equals_pillow_on_pillow_pngs(mode):
    arr = textured(48, 57, MODES[mode], seed=MODES[mode])
    data = pillow_png(arr, mode)
    assert len(row_filters(data)) > 1  # a mix of filters
    mine = decode_png(data)
    ref = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(mine, ref.reshape(mine.shape))
    np.testing.assert_array_equal(to_rgb(mine),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def filtered_png(arr, filters):
    """Encode uint8 [H, W, C] with row r filtered by filters[r % len(filters)]."""
    H, W, C = arr.shape
    img = arr.reshape(H, W * C).astype(np.int32)
    rows = []
    for r in range(H):
        cur = img[r]
        up = img[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int32), cur[:-C]])
        ul = np.concatenate([np.zeros(C, np.int32), up[:-C]])
        f = filters[r % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 1, 0, 2)])
def test_png_reader_undoes_every_row_filter(channels, filters):
    arr = np.random.RandomState(channels).randint(0, 256, (9, 11, channels)).astype(np.uint8)
    data = filtered_png(arr, filters)
    np.testing.assert_array_equal(decode_png(data), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))).reshape(arr.shape),
                                  arr)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_reads_the_port_writer(channels):
    arr = np.random.RandomState(channels).randint(0, 256, (6, 5, channels)).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(arr)), arr)


@pytest.mark.parametrize("fmt", ["JPEG", "BMP", "PNG16", "PALETTE"])
def test_other_images_raise_naming_the_file(tmp_path, fmt):
    path = str(tmp_path / "img.bin")
    arr = textured(8, 8, 3, 0)
    if fmt == "PNG16":
        Image.fromarray(arr[..., 0].astype(np.uint16) * 200).save(path, format="PNG")
    elif fmt == "PALETTE":
        Image.fromarray(arr).convert("P").save(path, format="PNG")
    else:
        Image.fromarray(arr).save(path, format=fmt)
    with pytest.raises(ValueError, match=r"img\.bin: .*does not use Pillow"):
        read_png(path)


@pytest.mark.parametrize("src,dst", [((300, 300), (256, 256)), ((512, 512), (64, 64)),
                                     ((48, 48), (64, 64)), ((300, 200), (256, 256)),
                                     ((37, 53), (29, 71))])
def test_resize_within_one_level_of_pillow_bilinear(src, dst):
    arr = textured(*src, 3, seed=sum(src))
    ref = np.asarray(Image.fromarray(arr).resize(dst[::-1], Image.BILINEAR))
    mine = resize_bilinear(arr, dst)
    assert mine.shape == ref.shape
    assert np.abs(mine.astype(int) - ref).max() <= 1


def test_grid_equals_the_jax_package():
    from bbdm_tpu.utils.images import get_image_grid as jax_grid

    batch = np.random.RandomState(0).uniform(-1.2, 1.2, (6, 5, 7, 3)).astype(np.float32)
    for n in (1, 3, 6):
        np.testing.assert_array_equal(get_image_grid(batch[:n]), jax_grid(batch[:n]))


def make_dataset(root, n_test=5, size=16, file_size=16):
    rs = np.random.RandomState(0)
    for stage, n in (("train", 3), ("val", 4), ("test", n_test)):
        for side in "AB":
            d = os.path.join(root, stage, side)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                arr = textured(file_size, file_size, 3, seed=rs.randint(1 << 30))
                if side == "A" and i % 2:  # Pillow-written, gray
                    Image.fromarray(arr[..., 0]).save(os.path.join(d, f"im{i:02d}.png"))
                else:
                    write_png(os.path.join(d, f"im{i:02d}.png"), arr)


def data_config(root, size=16, kind="custom_aligned", flip=False):
    return dict2namespace({"dataset_type": kind, "dataset_config": {
        "dataset_path": root, "image_size": size, "channels": 3, "to_normal": True,
        "flip": flip}})


@pytest.mark.parametrize("kind", ["custom_aligned", "custom_single"])
@pytest.mark.parametrize("file_size", [16, 23])
def test_loader_batches_equal_the_jax_package(tmp_path, kind, file_size):
    """Arrays, names and order of the test loader (drop_last) and of the
    shuffled val loader over two epochs. Files at the image size load equal
    (up to float rounding); resized ones within one uint8 level (the JAX
    package resizes in float, the port as Pillow does)."""
    root = str(tmp_path)
    make_dataset(root, file_size=file_size)
    cfg = data_config(root, kind=kind)
    mine, ref = get_dataset(cfg), jax_get_dataset(cfg)
    atol = 1e-6 if file_size == 16 else 2.0 / 255 + 1e-6
    for stage, shuffle in ((2, False), (1, True)):
        a = DataLoader(mine[stage], 2, shuffle=shuffle, seed=5)
        b = JaxLoader(ref[stage], 2, shuffle=shuffle, drop_last=True, seed=5)
        assert len(a) == len(b) == len(ref[stage]) // 2
        for epoch in (0, 1):
            a.set_epoch(epoch), b.set_epoch(epoch)
            got, want = list(a), list(b)
            assert len(got) == len(want)
            for x, y in zip(got, want):
                assert x["x_name"] == y["x_name"] and x["x_cond_name"] == y["x_cond_name"]
                for key in ("x", "x_cond"):
                    assert x[key].dtype == np.float32 and x[key].shape == y[key].shape
                    np.testing.assert_allclose(x[key], y[key], rtol=0, atol=atol)


def test_flip_doubles_the_train_set(tmp_path):
    root = str(tmp_path)
    make_dataset(root)
    train = get_dataset(data_config(root, flip=True))[0]
    assert len(train) == 6
    (x, name), _ = train[0]
    (xf, name_f), _ = train[3]
    assert name == name_f
    np.testing.assert_array_equal(xf, x[:, ::-1])


def test_loader_raises_a_decode_error(tmp_path):
    root = str(tmp_path)
    make_dataset(root)
    with open(os.path.join(root, "test", "B", "im01.png"), "wb") as f:
        f.write(b"not an image")
    loader = DataLoader(get_dataset(data_config(root))[2], 2)
    with pytest.raises(ValueError, match="im01.png"):
        list(loader)


def test_unported_dataset_type_raises(tmp_path):
    """Every dataset type of the JAX package is ported; a type neither package
    registers raises, naming the five."""
    with pytest.raises(NotImplementedError, match="custom_inpainting"):
        get_dataset(data_config(str(tmp_path), kind="custom_unknown"))
