"""The port's WebP reading (``bbdm_tpu_torch/native/webp.cpp`` through
``utils/images.py:read_image``) against Pillow 12.1 with its libwebp 1.6.0 and
against OpenCV, which are the yardstick here only (the port imports neither).

Tolerance 0 throughout: every committed fixture
(``tests/data/torch_images/webp/``, see its ``make_webp_fixtures.py``) equals
its stored array and Pillow's live ``convert("RGB")``; with ``imread=True``
it equals ``cv2.imread(f)[..., ::-1]`` (the EXIF file turned); random files
written by Pillow (quality x method x lossless x alpha, up to 64^2) equal
Pillow's decode; truncated and bit-flipped fixtures raise ValueError naming
the file, or decode. The WebP datasets equal the JAX package's within
``test_torch_datasets.py``'s bars, and the metrics over a lossless-WebP copy
of a PNG tree equal the PNG tree's values exactly.
"""

import functools
import hashlib
import io
import os
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from bbdm_tpu.config import dict2namespace
from bbdm_tpu.data import DataLoader as JaxLoader
from bbdm_tpu.data import get_dataset as jax_get_dataset
from bbdm_tpu_torch.data import DataLoader, get_dataset
from bbdm_tpu_torch.evaluation import diversity as pdiv
from bbdm_tpu_torch.evaluation import lpips as plp
from bbdm_tpu_torch.evaluation import pixel_metrics as ppix
from bbdm_tpu_torch.utils.images import decode_image, exif_orientation, read_image, write_png
from tests.data.torch_images.make_fixtures import textured
from tests.data.torch_images.webp.make_webp_fixtures import (
    chunk,
    chunks,
    riff,
    u24,
    vp8_header,
)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_images",
                        "webp")
SMALL = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".webp") and "_256" not in f)
BIG = sorted(f for f in os.listdir(FIXTURES) if f.endswith("_256.webp")) + sorted(
    f"tree256/{f}" for f in os.listdir(os.path.join(FIXTURES, "tree256")))
EXIF = "exif_orientation6.webp"


@functools.lru_cache(maxsize=1)
def expected():
    """The stored arrays (differences along W) and digests of make_webp_fixtures.py."""
    with np.load(os.path.join(FIXTURES, "expected.npz")) as z:
        return {k: z[k].tobytes() if k.startswith("sha256:") else
                np.cumsum(z[k], axis=1, dtype=np.uint8) for k in z.files}


def pillow_rgb(path_or_bytes):
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    return np.asarray(Image.open(src).convert("RGB"))


def read_bytes(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


# ------------------------------------------------------------------ fixtures

def test_fixtures_cover_every_kind():
    """The VP8 headers say what the encoder was asked for; the containers hold
    ALPH (raw and compressed), VP8L, ANMF and the extra chunks."""
    headers = {n: vp8_header(read_bytes(n)) for n in SMALL if n.startswith("vp8_")}
    assert {h[1] for h in headers.values() if h[2] > 0} == {"simple", "normal"}
    assert {h[3] for h in headers.values() if h[2] > 0} == {0, 3, 7}
    assert min(h[2] for h in headers.values()) == 0 and max(h[2] for h in headers.values()) > 40
    assert {h[0] for h in headers.values()} == {0, 1}
    assert {h[4] for h in headers.values()} == {1, 2, 4, 8}
    alph = {n: dict(chunks(read_bytes(n)))[b"ALPH"][0] & 3 for n in SMALL
            if n.startswith("vp8_alph")}
    assert sorted(alph.values()) == [0, 1]  # raw, lossless-compressed
    tags = {t for n in SMALL for t, _ in chunks(read_bytes(n))}
    assert {b"VP8 ", b"VP8L", b"VP8X", b"ALPH", b"ANIM", b"ANMF", b"EXIF", b"ICCP", b"XMP ",
            b"ABCD"} <= tags
    sizes = {Image.open(os.path.join(FIXTURES, n)).size for n in SMALL}
    assert {(1, 1), (17, 1), (1, 17), (13, 15), (47, 33)} <= sizes


@pytest.mark.parametrize("name", SMALL + BIG)
def test_fixture_equals_its_stored_array_and_pillow(name):
    path = os.path.join(FIXTURES, name)
    got = read_image(path)
    want = pillow_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    stored = expected()
    if name in SMALL:
        np.testing.assert_array_equal(got, stored[name])
    else:
        assert hashlib.sha256(got.tobytes()).digest() == stored[f"sha256:{name}"]


@pytest.mark.parametrize("name", SMALL + BIG)
def test_imread_equals_cv2(name):
    path = os.path.join(FIXTURES, name)
    got = read_image(path, imread=True)
    np.testing.assert_array_equal(got, cv2.imread(path)[..., ::-1])
    if name == EXIF:
        np.testing.assert_array_equal(got, expected()[f"imread:{EXIF}"])
        assert got.shape[:2] == pillow_rgb(path).shape[:2][::-1]


def test_exif_orientation_reads_the_webp_exif_chunk(tmp_path):
    """6 from the fixture's EXIF chunk; a chunk that starts with ``Exif\\0\\0``
    is no TIFF block to OpenCV, which then leaves the image as it is."""
    data = read_bytes(EXIF)
    assert exif_orientation(data) == 6
    assert all(exif_orientation(read_bytes(n)) == 1 for n in SMALL if n != EXIF)
    tiff = dict(chunks(data))[b"EXIF"]
    body = b"".join(chunk(t, b) for t, b in chunks(data) if t != b"EXIF")
    path = tmp_path / "prefixed.webp"
    path.write_bytes(riff(body, chunk(b"EXIF", b"Exif\0\0" + tiff)))
    assert exif_orientation(path.read_bytes()) == 1
    np.testing.assert_array_equal(read_image(str(path), imread=True),
                                  cv2.imread(str(path))[..., ::-1])


@pytest.mark.parametrize("quality", [0, 40, 90, 100])
@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("alpha", [False, True])
def test_random_pillow_webps_equal_pillow(quality, method, lossless, alpha):
    rs = np.random.RandomState(1000 * quality + 10 * method + 2 * lossless + alpha)
    h, w = rs.randint(1, 65, 2)
    c = 4 if alpha else 3
    img = textured(h, w, c, rs.randint(1 << 20))
    if rs.rand() < 0.5:
        img = rs.randint(0, 256, img.shape).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="WEBP", quality=quality, method=method,
                              lossless=lossless)
    data = b.getvalue()
    np.testing.assert_array_equal(decode_image(data), pillow_rgb(data))


# ------------------------------------------------------------------ hostile input

MUTABLE = SMALL + ["vp8_q75_256.webp"]


@pytest.mark.parametrize("case", range(50))
def test_a_truncated_or_corrupted_file_raises_or_decodes(tmp_path, case):
    """Even cases cut the file short, odd ones flip 1-3 bits (half of them in
    the first 64 bytes, where the headers are). Either it reads as an RGB
    array, or it raises ValueError naming the file; nothing crashes."""
    rs = np.random.RandomState(case)
    data = bytearray(read_bytes(MUTABLE[rs.randint(len(MUTABLE))]))
    if case % 2 == 0:
        data = data[:rs.randint(0, len(data))]
    else:
        for _ in range(rs.randint(1, 4)):
            at = rs.randint(min(64, len(data))) if rs.rand() < 0.5 else rs.randint(len(data))
            data[at] ^= 1 << rs.randint(8)
    path = tmp_path / f"mutated{case}.webp"
    path.write_bytes(bytes(data))
    try:
        img = read_image(str(path))
    except ValueError as e:
        assert f"mutated{case}.webp" in str(e)
    else:
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3


def test_an_image_past_the_decompression_bomb_limit_raises():
    """A canvas is allocated before its frame is decoded: an animation's of
    2^24 x 2^24 pixels, and a bare VP8 or VP8L frame of 16383 x 16383, are
    refused first, as Pillow refuses them."""
    frame = chunks(read_bytes("vp8_1x1.webp"))[0]
    data = riff(chunk(b"VP8X", bytes([2, 0, 0, 0]) + u24((1 << 24) - 1) * 2),
                chunk(b"ANMF", u24(0) * 4 + u24(0) + b"\0" + chunk(*frame)))
    with pytest.raises(ValueError, match="decompression-bomb"):
        decode_image(data)
    vp8 = bytearray(frame[1])
    vp8[6:10] = struct.pack("<HH", 16383, 16383)
    with pytest.raises(ValueError, match="decompression-bomb"):
        decode_image(riff(chunk(b"VP8 ", bytes(vp8))))
    vp8l = b"\x2f" + struct.pack("<I", 16382 | 16382 << 14) + bytes(16)
    with pytest.raises(ValueError, match="decompression-bomb"):
        decode_image(riff(chunk(b"VP8L", vp8l)))


def test_the_riff_size_is_checked():
    data = bytearray(read_bytes("vp8_15x13.webp"))
    data[4:8] = struct.pack("<I", len(data))  # 8 bytes past the end
    with pytest.raises(ValueError, match="truncated file"):
        decode_image(bytes(data))


# ------------------------------------------------------------------ datasets

def webp_file(path, arr, rs):
    """Lossy, lossless or lossy with alpha, by the draw."""
    kind = rs.randint(3)
    img = Image.fromarray(arr)
    if kind == 2:
        img = Image.fromarray(np.concatenate([arr, rs.randint(0, 256, arr.shape[:2] + (1,),
                                                              dtype=np.uint8)], 2))
    img.save(path, format="WEBP", quality=int(rs.randint(30, 95)), lossless=kind == 1)


def loaders_equal(mine, ref, atol, exact=False):
    for stage, shuffle in ((0, True), (2, False)):
        a = DataLoader(mine[stage], 2, shuffle=shuffle, seed=5, num_workers=2)
        b = JaxLoader(ref[stage], 2, shuffle=shuffle, drop_last=True, seed=5, num_workers=0)
        assert len(a) == len(b) > 0
        for x, y in zip(list(a), list(b)):
            assert x["x_name"] == y["x_name"] and x["x_cond_name"] == y["x_cond_name"]
            for key in ("x", "x_cond"):
                assert x[key].dtype == np.float32 and x[key].shape == y[key].shape
                if exact:
                    np.testing.assert_array_equal(x[key], y[key])
                else:
                    np.testing.assert_allclose(x[key], y[key], rtol=0, atol=atol)


@pytest.mark.parametrize("file_size", [16, 23])
def test_custom_aligned_webp_tree_equals_the_jax_package(tmp_path, file_size):
    """A/B pairs of WebP files through both packages' ``custom_aligned``
    loaders (the JAX package reads with Pillow): 1e-6 at the image size, one
    uint8 level resized (the JAX package resamples in float32)."""
    rs = np.random.RandomState(file_size)
    for stage, n in (("train", 4), ("val", 2), ("test", 4)):
        for side in "AB":
            os.makedirs(tmp_path / stage / side)
            for i in range(n):
                webp_file(tmp_path / stage / side / f"im{i}.webp",
                          textured(file_size, file_size, 3, rs.randint(1 << 20)), rs)
    cfg = dict2namespace({"dataset_type": "custom_aligned", "dataset_config": {
        "dataset_path": str(tmp_path), "image_size": 16, "channels": 3, "to_normal": True,
        "flip": True}})
    atol = 1e-6 if file_size == 16 else 2.0 / 255 + 1e-6
    loaders_equal(get_dataset(cfg), jax_get_dataset(cfg), atol)


def test_lab_webp_tree_equals_the_jax_package(tmp_path):
    """``custom_colorization_LAB`` over WebP files, the EXIF-rotated one among
    them: the JAX package reads them with ``cv2.imread``; exact."""
    rs = np.random.RandomState(3)
    exif = read_bytes(EXIF)
    for stage in ("train", "val", "test"):
        os.makedirs(tmp_path / stage)
        for i in range(3):
            webp_file(tmp_path / stage / f"im{i}.webp", textured(22, 13, 3, rs.randint(1 << 20)),
                      rs)
        (tmp_path / stage / "im3.webp").write_bytes(exif)  # 13 x 22, 22 x 13 turned
    cfg = dict2namespace({"dataset_type": "custom_colorization_LAB", "dataset_config": {
        "dataset_path": str(tmp_path), "image_size": 16, "channels": 3, "to_normal": True,
        "flip": False}})
    loaders_equal(get_dataset(cfg), jax_get_dataset(cfg), 0, exact=True)


# ------------------------------------------------------------------ evaluation

def test_metrics_over_a_lossless_webp_copy_equal_the_png_trees(tmp_path):
    """Paired LPIPS (random AlexNet-LPIPS weights), PSNR/SSIM/MSE and diversity
    over lossless WebP copies equal the PNG trees' values exactly. The
    diversity protocol names its files ``output_<j>.png``; its copies keep
    those names and hold WebP bytes, which the readers find by signature, as
    Pillow does."""
    rs = np.random.RandomState(0)
    trees = {}
    for fmt in ("png", "webp"):
        for d in ("gt", "flat"):
            os.makedirs(tmp_path / fmt / d)
        for i in range(3):
            os.makedirs(tmp_path / fmt / "data" / str(i))
        trees[fmt] = tmp_path / fmt
    for i in range(3):
        for rel in (f"gt/{i}", f"flat/{i}", f"data/{i}/output_0", f"data/{i}/output_1"):
            arr = textured(48, 48, 3, rs.randint(1 << 20))
            write_png(str(trees["png"] / f"{rel}.png"), arr)
            name = f"{rel}.png" if rel.startswith("data") else f"{rel}.webp"
            Image.fromarray(arr).save(trees["webp"] / name, format="WEBP", lossless=True,
                                      exact=True)
    torch.manual_seed(5)
    lp = plp.LPIPS("alex")
    with torch.no_grad():
        for k, v in lp.state_dict().items():
            if k.startswith("lin"):
                v.abs_()
    torch.save(lp.state_dict(), str(tmp_path / "lpips.pth"))
    values = {}
    for fmt, root in trees.items():
        values[fmt] = (
            plp.paired_LPIPS(str(root / "flat"), str(root / "gt"),
                             weights_path=str(tmp_path / "lpips.pth"), device="cpu"),
            ppix.calc_psnr_ssim(str(root / "flat"), str(root / "gt")),
            pdiv.calc_diversity(str(root / "data"), 2))
    assert values["webp"][1]["count"] == 3 and values["webp"][2] > 0
    assert values["webp"] == values["png"]
