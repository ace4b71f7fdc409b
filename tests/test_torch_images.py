"""The port's image readers and writers against Pillow and OpenCV, which are the
reference here only (the port imports neither): ``utils/images.py:read_image``
(PNG of every kind, JPEG through ``native/jpeg.cpp``, BMP) equal to
``Image.open(f).convert("RGB")`` on the committed fixtures
(``tests/data/torch_images/``) and on fresh files, and with ``imread=True``
equal to ``cv2.imread`` (EXIF orientation, 16-bit gray); ``data/colors.py`` equal to
``cv2.cvtColor(COLOR_BGR2LAB)`` on all 2^24 colours and to ``cv2.resize
(INTER_LINEAR)``; and the GIF writer read back by Pillow."""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from bbdm_tpu_torch.data.colors import resize_linear, rgb_to_lab
from bbdm_tpu_torch.utils.gif import encode_gif
from bbdm_tpu_torch.utils.images import decode_image, read_image
from tests.data.torch_images.make_fixtures import LAB_NAMES, bmp4_bytes, png_bytes, textured

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_images")
NAMES = sorted(f for f in os.listdir(FIXTURES) if f.endswith((".png", ".jpg", ".bmp")))
JPEG256 = sorted(os.listdir(os.path.join(FIXTURES, "jpeg256")))


def expected():
    """The stored arrays (differences along W, see make_fixtures.py) and digests."""
    with np.load(os.path.join(FIXTURES, "expected.npz")) as z:
        return {k: z[k].tobytes() if k.startswith("sha256:") else
                np.cumsum(z[k], axis=1, dtype=np.uint8) for k in z.files}


def pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_fixtures_cover_every_kind():
    kinds = {"444", "422", "420", "440", "progressive", "gray", "restart"}
    assert all(any(k in n for n in NAMES if n.endswith(".jpg")) for k in kinds)
    assert {"gray_1bit.png", "gray_2bit.png", "gray_16bit.png", "palette_trns.png",
            "rgba_interlaced.png", "rgb24.bmp", "bgra32_bitfields.bmp",
            "palette8.bmp"} <= set(NAMES)
    assert any(n.endswith("4bit_interlaced.png") for n in NAMES)
    assert sorted(expected()) == sorted(NAMES + [f"lab:{n}" for n in LAB_NAMES]
                                        + [f"sha256:jpeg256/{n}" for n in JPEG256])


@pytest.mark.parametrize("name", NAMES)
def test_read_image_equals_pillow_on_every_fixture(name):
    path = os.path.join(FIXTURES, name)
    got = read_image(path)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    with open(path, "rb") as f:
        np.testing.assert_array_equal(got, pillow_rgb(f.read()))
    np.testing.assert_array_equal(got, expected()[name])


@pytest.mark.parametrize("name", JPEG256)
def test_the_256_jpegs_equal_pillow_and_their_digest(name):
    import hashlib

    path = os.path.join(FIXTURES, "jpeg256", name)
    got = read_image(path)
    assert got.shape == (256, 256, 3)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(got, pillow_rgb(f.read()))
    assert hashlib.sha256(got.tobytes()).digest() == expected()[f"sha256:jpeg256/{name}"]


def test_webp_raises_naming_the_file_and_the_roadmap():
    """The WebP fixture of this directory reads as Pillow reads it (the WebP
    decoder's own tests are ``test_torch_webp.py``); a file that is not an
    image raises naming the file."""
    path = os.path.join(FIXTURES, "image.webp")
    with open(path, "rb") as f:
        np.testing.assert_array_equal(read_image(path), pillow_rgb(f.read()))
    with pytest.raises(ValueError, match=r"make_fixtures\.py: not a PNG, JPEG, BMP or WebP"):
        read_image(os.path.join(FIXTURES, "make_fixtures.py"))


@pytest.mark.parametrize("quality", [5, 30, 50, 75, 90, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_random_jpegs_equal_pillow(quality, subsampling, progressive):
    rs = np.random.RandomState(quality + 7 * subsampling + progressive)
    for h, w in ((1, 1), (2, 3), (9, 17), (37, 53), (64, 48)):
        arr = textured(h, w, 3, seed=rs.randint(1 << 20))
        if rs.rand() < 0.5:
            arr = rs.randint(0, 256, arr.shape).astype(np.uint8)
        b = io.BytesIO()
        Image.fromarray(arr).save(b, format="JPEG", quality=quality, subsampling=subsampling,
                                  progressive=progressive)
        np.testing.assert_array_equal(decode_image(b.getvalue()), pillow_rgb(b.getvalue()))


@pytest.mark.parametrize("depth,color,channels", [
    (1, 0, 1), (2, 0, 1), (4, 0, 1), (8, 0, 1), (16, 0, 1), (8, 2, 3), (16, 2, 3), (8, 4, 2),
    (16, 4, 2), (8, 6, 4), (16, 6, 4), (1, 3, 1), (2, 3, 1), (4, 3, 1), (8, 3, 1)])
@pytest.mark.parametrize("interlace", [0, 1])
def test_every_png_kind_equals_pillow(depth, color, channels, interlace):
    rs = np.random.RandomState(depth * 10 + color)
    for h, w in ((1, 1), (3, 2), (9, 17)):
        samples = rs.randint(0, 1 << depth, (h, w, channels))
        palette = rs.randint(0, 256, 3 * min(1 << depth, 200)).astype(np.uint8).tobytes() \
            if color == 3 else None
        data = png_bytes(samples, depth, color, interlace, palette=palette)
        np.testing.assert_array_equal(decode_image(data), pillow_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "1"])
def test_pillow_bmps_equal_pillow(mode):
    arr = textured(19, 23, 3, seed=1)
    b = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(b, format="BMP")
    np.testing.assert_array_equal(decode_image(b.getvalue()), pillow_rgb(b.getvalue()))


@pytest.mark.parametrize("top_down", [False, True])
def test_four_bit_bmp_equals_pillow(top_down):
    rs = np.random.RandomState(top_down)
    data = bmp4_bytes(rs.randint(0, 16, (7, 9)), rs.randint(0, 256, (16, 3)), top_down)
    np.testing.assert_array_equal(decode_image(data), pillow_rgb(data))


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


@pytest.mark.parametrize("kind", ["arithmetic", "lossless", "12-bit", "cmyk"])
def test_unsupported_jpegs_raise_naming_the_file_and_the_feature(tmp_path, kind):
    b = io.BytesIO()
    img = Image.fromarray(textured(16, 16, 4 if kind == "cmyk" else 3, seed=2),
                          "CMYK" if kind == "cmyk" else "RGB")
    img.save(b, format="JPEG", quality=80)
    data = b.getvalue()
    if kind == "arithmetic":
        data = _patched(data, b"\xff\xc0", b"\xff\xc9")
    elif kind == "lossless":
        data = _patched(data, b"\xff\xc0", b"\xff\xc3")
    elif kind == "12-bit":
        i = data.index(b"\xff\xc0")
        data = data[:i + 4] + bytes([12]) + data[i + 5:]
    path = tmp_path / "odd.jpg"
    path.write_bytes(data)
    words = {"arithmetic": "arithmetic coding", "lossless": "lossless", "12-bit": "12-bit",
             "cmyk": "CMYK"}[kind]
    with pytest.raises(ValueError, match=rf"odd\.jpg: .*{words}"):
        read_image(str(path))


def test_truncated_and_foreign_files_raise(tmp_path):
    with open(os.path.join(FIXTURES, "q85_420.jpg"), "rb") as f:
        head = f.read()[:200]
    for name, data in (("cut.jpg", head), ("text.png", b"hello"),
                       ("cut.png", b"\x89PNG\r\n\x1a\n")):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            read_image(str(tmp_path / name))


# ------------------------------------------------------------------ OpenCV

def test_lab_equals_cv2_on_every_colour():
    """All 2^24 colours, in chunks of 2^20: exact."""
    for hi in range(0, 256, 16):
        c = np.arange(hi << 16, (hi + 16) << 16, dtype=np.uint32)
        rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
        rgb = rgb.reshape(1024, 1024, 3)
        want = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]), cv2.COLOR_BGR2LAB)
        np.testing.assert_array_equal(rgb_to_lab(rgb), want)


@pytest.mark.parametrize("name", LAB_NAMES)
def test_lab_of_the_jpeg_fixtures_equals_cv2_imread(name):
    path = os.path.join(FIXTURES, name)
    got = rgb_to_lab(read_image(path, imread=True))
    np.testing.assert_array_equal(got, cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2LAB))
    np.testing.assert_array_equal(got, expected()[f"lab:{name}"])


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("orientation", range(0, 10))
def test_imread_applies_the_exif_orientation_as_cv2(tmp_path, fmt, orientation):
    """Orientations 1-8 turn the image as ``cv2.imread`` turns it; 0 and 9 are
    not orientations and leave it as it is; Pillow's reading never turns it."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / f"o.{fmt.lower()}")
    Image.fromarray(textured(13, 22, 3, orientation)).save(path, format=fmt, quality=90,
                                                           exif=exif.tobytes())
    got = read_image(path, imread=True)
    np.testing.assert_array_equal(got, cv2.imread(path)[..., ::-1])
    with open(path, "rb") as f:
        np.testing.assert_array_equal(read_image(path), pillow_rgb(f.read()))


@pytest.mark.parametrize("interlace", [0, 1])
def test_imread_keeps_the_high_byte_of_16_bit_gray_as_cv2(tmp_path, interlace):
    rs = np.random.RandomState(interlace)
    path = tmp_path / "g16.png"
    path.write_bytes(png_bytes(rs.randint(0, 65536, (9, 17, 1)), 16, 0, interlace))
    np.testing.assert_array_equal(read_image(str(path), imread=True),
                                  cv2.imread(str(path))[..., ::-1])


@pytest.mark.parametrize("src,dst", [((37, 53), (16, 16)), ((37, 53), (256, 256)),
                                     ((53, 37), (29, 71)), ((16, 16), (32, 32)),
                                     ((64, 64), (32, 32)), ((512, 512), (256, 256)),
                                     ((300, 200), (256, 256)), ((256, 256), (64, 64)),
                                     ((2, 2), (5, 5)), ((1, 3), (4, 4)), ((7, 1), (3, 9))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_equals_cv2(src, dst, channels):
    arr = np.random.RandomState(sum(src) + sum(dst)).randint(0, 256, (*src, channels))
    arr = arr.astype(np.uint8)
    want = cv2.resize(arr, dst[::-1], interpolation=cv2.INTER_LINEAR).reshape(*dst, channels)
    np.testing.assert_array_equal(resize_linear(arr, dst), want)


# --------------------------------------------------------------------- GIF

GIF_MEAN_BAR, GIF_MAX_BAR = 10.0, 48  # uint8 levels per decoded frame against its grid


def test_gif_reads_back_through_pillow():
    """Frames (a repeated one folded, as Pillow folds it), size, delay 0 and
    loop 0 as Pillow writes ``save_all=True, duration=1, loop=0``; each decoded
    frame within the stated mean and max error of its grid, and within 1.5
    levels of Pillow's own mean error on the same grid."""
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:70, 0:134]
    frames = [np.clip(np.stack([np.sin(yy / 9 + k) * 100 + 128, xx * 1.8,
                                np.cos(xx / 13 + k) * 100 + 128], -1)
                      + rs.randint(0, 12, (70, 134, 3)), 0, 255).astype(np.uint8)
              for k in range(3)]
    frames.append(frames[-1])
    frames.append(np.full((70, 134, 3), 9, np.uint8))  # a few colours: exact
    mine = Image.open(io.BytesIO(encode_gif(frames, duration=1, loop=0)))
    b = io.BytesIO()
    pil = [Image.fromarray(f) for f in frames]
    pil[0].save(b, format="GIF", save_all=True, append_images=pil[1:], duration=1, loop=0)
    ref = Image.open(io.BytesIO(b.getvalue()))
    assert mine.n_frames == ref.n_frames == 4 and mine.size == ref.size == (134, 70)
    assert mine.info["loop"] == ref.info["loop"] == 0
    assert mine.info.get("duration", 0) == ref.info.get("duration", 0) == 0
    kept = frames[:3] + frames[4:]
    for i, grid in enumerate(kept):
        mine.seek(i)
        ref.seek(i)
        err = np.abs(np.asarray(mine.convert("RGB")).astype(int) - grid)
        err_ref = np.abs(np.asarray(ref.convert("RGB")).astype(int) - grid)
        assert err.mean() <= GIF_MEAN_BAR and err.max() <= GIF_MAX_BAR, (i, err.mean(), err.max())
        assert err.mean() <= err_ref.mean() + 1.5
    assert err.max() == 0


@pytest.mark.parametrize("kw", [dict(save_interval=3), dict(save_interval=4, gif_interval=2),
                                dict(save_interval=5, head_threshold=6, tail_threshold=2,
                                     gif_interval=3)])
def test_save_images_writes_the_jax_runner_files(tmp_path, kw):
    """``BBDMRunner.save_images`` against ``DiffusionBaseRunner.save_images``
    on one trajectory: the same files, the PNGs equal, the GIFs of the same
    frame count, size and loop."""
    from types import SimpleNamespace

    from bbdm_tpu.runners.diffusion_base import DiffusionBaseRunner
    from bbdm_tpu_torch.runners.bbdm import BBDMRunner

    traj = np.random.RandomState(1).uniform(-1, 1, (9, 3, 10, 12, 3)).astype(np.float32)
    for s in range(1, 9):  # a smooth trajectory: few colours per frame
        traj[s] = 0.7 * traj[s - 1] + 0.3 * np.round(traj[s], 1)
    me = SimpleNamespace(config=SimpleNamespace(data=SimpleNamespace(
        dataset_config=SimpleNamespace(to_normal=True))), writer=None, is_main_process=True)
    for name, fn in (("jax", DiffusionBaseRunner.save_images), ("port", BBDMRunner.save_images)):
        os.makedirs(tmp_path / name)
        fn(me, traj, str(tmp_path / name), 2, **kw)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert ("movie.gif" in files) == (kw.get("gif_interval", -1) > 0)
    for f in files:
        a, b = (Image.open(tmp_path / side / f) for side in ("jax", "port"))
        if f.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert (a.n_frames, a.size, a.info["loop"]) == (b.n_frames, b.size, b.info["loop"])
