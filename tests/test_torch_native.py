"""The port's host image library (``bbdm_tpu_torch/native/``) against its numpy
plain versions, bit for bit: the PNG row filters (``utils/images.py:_unfilter``),
Pillow's fixed-point resize (``data/base.py:resize_bilinear``) and the whole
``load_image`` pass (``data/base.py:load_image_plain``); and its build: two
processes building one cold library at once, and a failed compiler raising."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from bbdm_tpu_torch.data.base import load_image, load_image_plain, resize_bilinear
from bbdm_tpu_torch.native import fastimage
from bbdm_tpu_torch.utils.images import _unfilter, write_png
from tests.test_torch_data import filtered_png, textured

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESIZES = [((300, 300), (256, 256)), ((512, 512), (64, 64)), ((48, 48), (64, 64)),
           ((300, 200), (256, 256)), ((37, 53), (29, 71)),  # test_resize_within_one_level...
           ((5, 3), (7, 2)), ((1, 1), (4, 3)), ((64, 64), (64, 64))]


def idat(data: bytes) -> bytes:
    """The inflated image data of a PNG written by ``filtered_png``."""
    pos, chunks = 8, []
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            chunks.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return zlib.decompress(b"".join(chunks))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 1, 0, 2)])
def test_unfilter_equals_the_numpy_version(channels, filters):
    arr = np.random.RandomState(channels).randint(0, 256, (13, 17, channels)).astype(np.uint8)
    rows = idat(filtered_png(arr, filters))
    got = fastimage.unfilter(rows, 13, 17 * channels, channels)
    np.testing.assert_array_equal(got, _unfilter(rows, 13, 17, channels))
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)


def test_unfilter_rejects_a_bad_filter_and_size():
    rows = bytearray(idat(filtered_png(np.zeros((3, 4, 3), np.uint8), (0,))))
    rows[13] = 7  # row 1's filter byte
    with pytest.raises(ValueError, match="row 1: filter type 7"):
        fastimage.unfilter(bytes(rows), 3, 12, 3)
    with pytest.raises(ValueError, match="holds 38 bytes, expected 39"):
        fastimage.unfilter(bytes(rows[:-1]), 3, 12, 3)


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_resize_equals_the_numpy_version(src, dst, channels):
    """The C pass without flip and normalisation is u8 / 255 in float32 of the
    resized image, which keeps every uint8 level apart: equal floats, equal
    resize."""
    arr = textured(*src, channels, seed=sum(src) + channels)
    want = resize_bilinear(np.repeat(arr[..., :1], 3, -1) if channels < 3 else arr[..., :3], dst)
    got = fastimage.preprocess_image(arr, dst, False, False)
    np.testing.assert_array_equal(got, want.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(np.rint(got * 255.0).astype(np.uint8), want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("size", [(16, 16), (23, 23), (40, 29)])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("to_normal", [False, True])
def test_load_image_equals_the_plain_version(tmp_path, channels, size, flip, to_normal):
    """The host library's pass over an 8-bit PNG (unfilter; RGB, resize, flip,
    float32) against the numpy path, exactly, for every row filter."""
    arr = textured(23, 23, channels, seed=channels)
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(filtered_png(arr, (4, 3, 1, 0, 2)))
    got = load_image(path, size, flip, to_normal)
    assert got.dtype == np.float32 and got.shape == (*size, 3)
    np.testing.assert_array_equal(got, load_image_plain(path, size, flip, to_normal))
    write_png(path, arr)
    np.testing.assert_array_equal(load_image(path, size, flip, to_normal),
                                  load_image_plain(path, size, flip, to_normal))


def run_python(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO, **env))


def test_two_processes_build_one_cold_library(tmp_path):
    """Both processes wait on the lock, one compiles, both load the same file."""
    code = ("import sys\n"
            "from bbdm_tpu_torch.native import build\n"
            f"build.BUILD_DIR = {str(tmp_path)!r}\n"
            "from bbdm_tpu_torch.native import fastimage\n"
            "import numpy as np\n"
            "out = fastimage.preprocess_image(np.full((4, 4, 3), 51, np.uint8), (2, 2), False,\n"
            "                                 False)\n"
            "assert (out == np.float32(0.2)).all()\n"
            "print(build.build())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=REPO)) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = sorted(os.listdir(tmp_path))
    assert built == sorted([os.path.basename(paths.pop()), "fastimage.lock"]), built


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path):
    """With the compiler pointed at /bin/false, reading a JPEG or loading a PNG
    raises RuntimeError; nothing decodes another way."""
    jpeg = os.path.join(REPO, "tests", "data", "torch_images", "q85_420.jpg")
    png = str(tmp_path / "a.png")
    write_png(png, np.zeros((4, 4, 3), np.uint8))
    code = ("from bbdm_tpu_torch.native import build\n"
            f"build.BUILD_DIR = {str(tmp_path / 'build')!r}\n"
            "from bbdm_tpu_torch.utils.images import read_image\n"
            "from bbdm_tpu_torch.data.base import load_image\n"
            "for call in (lambda: read_image(%r), lambda: load_image(%r, (4, 4), False, False)):\n"
            "    try:\n"
            "        call()\n"
            "    except RuntimeError as e:\n"
            "        print('raised:', e)\n"
            "    else:\n"
            "        raise SystemExit('no error')\n") % (jpeg, png)
    proc = run_python(code, CXX="/bin/false")
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert proc.stdout.count("raised: ") == 2 and "/bin/false" in proc.stdout
    assert not os.path.exists(tmp_path / "build") or not any(
        f.endswith(".so") for f in os.listdir(tmp_path / "build"))
