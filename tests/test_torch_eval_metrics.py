"""The port's evaluation protocols and metric CLI (``bbdm_tpu_torch/evaluation/``,
``preprocess_and_evaluation_torch.py``) against the JAX package's
(``bbdm_tpu/evaluation/``, ``preprocess_and_evaluation.py``), on the CPU.

One module-scoped tree of small PNGs written by the port's ``write_png`` (48^2,
gray, gray+alpha, RGB and RGBA files mixed, so the readers' RGB conversion is
exercised), seeded He-random InceptionV3 and random AlexNet-LPIPS weights saved
as torch ``.pth`` state dicts, and the JAX CLI run once per ``-f`` mode on it
(its printed values are the JAX functions' values: the CLI prints what they
return). Bars: LPIPS distances 1e-5 relative; FID 1e-4 relative (the features
agree to ~1e-6 of their norm, the matrix square root of a rank-deficient
covariance product loosens that); diversity and PSNR/SSIM/MSE exact to 1e-12
(the same float64 numpy on the same bytes). ``to_rgb`` equals Pillow's
``convert("RGB")`` for every PNG colour type the port reads.
"""

import contextlib
import io
import os
import random
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import preprocess_and_evaluation as jax_cli
from bbdm_tpu.evaluation import diversity as jdiv
from bbdm_tpu.evaluation import fid as jfid
from bbdm_tpu.evaluation import lpips as jlp
from bbdm_tpu.evaluation import pixel_metrics as jpix
from bbdm_tpu_torch.evaluation import cli
from bbdm_tpu_torch.evaluation import diversity as pdiv
from bbdm_tpu_torch.evaluation import fid as pfid
from bbdm_tpu_torch.evaluation import lpips as plp
from bbdm_tpu_torch.evaluation import pixel_metrics as ppix
from bbdm_tpu_torch.evaluation.inception import FIDInceptionV3
from bbdm_tpu_torch.utils.images import read_png, to_rgb, write_png

SIZE, N, DRAWS = 48, 4, 2
CHANNELS = (3, 1, 4, 2)  # image i is written with CHANNELS[i % 4] channels


def he_inception(seed=3):
    """The port's InceptionV3 with He-normal conv kernels (as
    ``scripts/make_random_inception.py``) and non-trivial BatchNorm statistics."""
    torch.manual_seed(seed)
    m = FIDInceptionV3()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k, v in m.state_dict().items():
            if k.endswith("conv.weight"):
                torch.nn.init.kaiming_normal_(v, nonlinearity="relu")
            elif k.endswith("running_mean"):
                v.uniform_(-0.3, 0.3, generator=g)
            elif k.endswith("running_var"):
                v.uniform_(0.2, 1.5, generator=g)
            elif k.endswith("bn.weight"):
                v.uniform_(0.5, 1.5, generator=g)
            elif k.endswith("bn.bias"):
                v.uniform_(-0.3, 0.3, generator=g)
    return m


def random_lpips(net, seed=5):
    """``LPIPS(net)`` with torch's default init and non-negative heads."""
    torch.manual_seed(seed)
    m = plp.LPIPS(net)
    with torch.no_grad():
        for k, v in m.state_dict().items():
            if k.startswith("lin"):
                v.abs_()
    return m


def image(rs, channels):
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    img = np.sin(6 * yy[..., None] + 4 * xx[..., None] + rs.uniform(0, 2 * np.pi, channels))
    img = img + rs.uniform(-0.3, 0.3, (SIZE, SIZE, channels))
    return np.clip(img * 127.5 + 128, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """gt/<i>.png; data/<i>/output_<j>.png (DRAWS draws); flat/<i>.png (one draw);
    other/<i>.png (another image set, for FID); st/<name>/output_<j>.png (a
    sample_to_eval tree by dataset names); the weights."""
    root = tmp_path_factory.mktemp("eval")
    rs = np.random.RandomState(0)
    for d in ("gt", "flat", "other", "data"):
        os.makedirs(root / d)
    for i in range(N):
        c = CHANNELS[i % 4]
        write_png(str(root / "gt" / f"{i}.png"), image(rs, c))
        write_png(str(root / "flat" / f"{i}.png"), image(rs, CHANNELS[(i + 1) % 4]))
        write_png(str(root / "other" / f"{i}.png"), image(rs, 3))
        os.makedirs(root / "data" / str(i))
        for j in range(DRAWS):
            write_png(str(root / "data" / str(i) / f"output_{j}.png"), image(rs, c))
    for name in ("0007", "0012", "0031"):
        os.makedirs(root / "st" / name)
        for j in range(DRAWS):
            write_png(str(root / "st" / name / f"output_{j}.png"), image(rs, 3))
    torch.save(he_inception().state_dict(), str(root / "inception.pth"))
    torch.save(random_lpips("alex").state_dict(), str(root / "lpips_alex.pth"))
    return root


def run(main, argv, seed=0):
    """stdout of one CLI run (``random`` seeded first, for max_min_LPIPS)."""
    random.seed(seed)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def run_jax_cli(argv):
    saved = sys.argv
    sys.argv = ["preprocess_and_evaluation.py"] + argv
    try:
        return run(lambda _: jax_cli.main(), argv)
    finally:
        sys.argv = saved


def mode_argv(tree, mode):
    t = str(tree)
    return {"LPIPS": ["-f", "LPIPS", "-s", f"{t}/data", "-t", f"{t}/gt", "-n", str(DRAWS),
                      "--weights", f"{t}/lpips_alex.pth"],
            "max_min_LPIPS": ["-f", "max_min_LPIPS", "-s", f"{t}/data", "-t", f"{t}/gt", "-n",
                              str(DRAWS), "--weights", f"{t}/lpips_alex.pth"],
            "diversity": ["-f", "diversity", "-s", f"{t}/data", "-n", str(DRAWS)],
            "FID": ["-f", "FID", "-s", f"{t}/gt", "-t", f"{t}/other", "--weights",
                    f"{t}/inception.pth"],
            "psnr_ssim": ["-f", "psnr_ssim", "-s", f"{t}/flat", "-t", f"{t}/gt"]}[mode]


@pytest.fixture(scope="module")
def jax_printed(tree):
    """The JAX CLI's stdout per metric mode."""
    return {m: run_jax_cli(mode_argv(tree, m))
            for m in ("LPIPS", "max_min_LPIPS", "diversity", "FID", "psnr_ssim")}


def number(text, label):
    return [float(v) for v in re.findall(rf"{label}\s*[:=]\s*([-+0-9.eE]+)", text)]


# ------------------------------------------------------------------- readers

@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_to_rgb_equals_pillow_convert_rgb(tmp_path, channels):
    img = image(np.random.RandomState(channels), channels)
    write_png(str(tmp_path / "a.png"), img[..., 0] if channels == 1 else img)
    want = np.asarray(Image.open(str(tmp_path / "a.png")).convert("RGB"))
    np.testing.assert_array_equal(to_rgb(read_png(str(tmp_path / "a.png"))), want)


def test_non_png_images_raise_naming_the_roadmap_item(tmp_path):
    write_png(str(tmp_path / "a.png"), np.zeros((4, 4, 3), np.uint8))
    (tmp_path / "b.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match=r"ROADMAP.md §1 item 11"):
        pfid.image_files(str(tmp_path))


# ------------------------------------------------------------------- metrics

def test_frechet_distance_matches():
    rs = np.random.RandomState(0)
    f1, f2 = rs.randn(40, 6), rs.randn(30, 6) * 1.3 + 0.2
    got = pfid.frechet_distance(*pfid.activation_statistics(f1), *pfid.activation_statistics(f2))
    want = jfid.frechet_distance(*jfid.activation_statistics(f1), *jfid.activation_statistics(f2))
    assert got == pytest.approx(want, rel=1e-12)
    assert pfid.frechet_distance(np.zeros(3), np.eye(3), np.zeros(3), np.eye(3)) == \
        pytest.approx(0.0, abs=1e-9)


def test_calc_fid_matches(tree, jax_printed):
    """``calc_FID`` through the CLI's ``-f FID --cpu``, which returns and prints
    its value: the printed text against the JAX CLI's, the value against the
    JAX ``calc_FID``'s (one scipy ``sqrtm`` of a 2048^2 matrix per side, ~15 s
    of CPU each)."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        got = cli.main(mode_argv(tree, "FID") + ["--cpu"])
    (want,) = number(jax_printed["FID"], "FID value")
    assert number(text.getvalue(), "FID value") == [got]
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-4)


def test_calc_lpips_matches(tree, jax_printed):
    got = plp.calc_LPIPS(str(tree / "data"), str(tree / "gt"), DRAWS,
                         weights_path=str(tree / "lpips_alex.pth"), device="cpu")
    (want,) = number(jax_printed["LPIPS"], "lpips_distance")
    assert got == pytest.approx(want, rel=1e-5)


def test_paired_lpips_matches(tree):
    kw = {"weights_path": str(tree / "lpips_alex.pth")}
    got = plp.paired_LPIPS(str(tree / "flat"), str(tree / "gt"), device="cpu", **kw)
    want = jlp.paired_LPIPS(str(tree / "flat"), str(tree / "gt"), **kw)
    assert got == pytest.approx(want, rel=1e-5)


def test_find_max_min_lpips_draws_as_the_jax_package(tree, jax_printed):
    random.seed(0)
    got = plp.find_max_min_LPIPS(str(tree / "data"), str(tree / "gt"), DRAWS,
                                 weights_path=str(tree / "lpips_alex.pth"), device="cpu")
    want = number(jax_printed["max_min_LPIPS"], "max_LPIPS")[-1], \
        number(jax_printed["max_min_LPIPS"], "min_LPIPS")[-1]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] > got[1]  # the draws differ


def test_calc_diversity_matches(tree):
    for use_names in (False, True):
        got = pdiv.calc_diversity(str(tree / "data"), DRAWS, use_names=use_names)
        want = jdiv.calc_diversity(str(tree / "data"), DRAWS, use_names=use_names)
        assert got == pytest.approx(want, rel=1e-12) and got > 0


def test_calc_psnr_ssim_matches(tree):
    got = ppix.calc_psnr_ssim(str(tree / "flat"), str(tree / "gt"))
    want = jpix.calc_psnr_ssim(str(tree / "flat"), str(tree / "gt"))
    assert got.keys() == want.keys() and got["count"] == want["count"] == N
    for k in ("psnr", "ssim", "mse"):
        assert got[k] == pytest.approx(want[k], rel=1e-12)


# ----------------------------------------------------------------------- CLI

@pytest.mark.parametrize("mode", ["LPIPS", "max_min_LPIPS", "diversity", "psnr_ssim"])
def test_cli_mode_prints_the_jax_cli_value(tree, jax_printed, mode):
    """Each metric mode with ``--cpu`` (``-f FID``: ``test_calc_fid_matches``)."""
    got = run(cli.main, mode_argv(tree, mode) + ["--cpu"])
    want = jax_printed[mode]
    label = {"LPIPS": "lpips_distance", "max_min_LPIPS": "(?:max|min)_LPIPS",
             "diversity": "diversity", "psnr_ssim": "PSNR"}[mode]
    a, b = number(got, label), number(want, label)
    assert len(a) == len(b) > 0
    np.testing.assert_allclose(a, b, rtol=1e-5)
    if mode in ("diversity", "psnr_ssim"):
        assert got == want  # the same numpy on the same bytes: the same text


@pytest.mark.parametrize("mode", ["rename_samples", "copy_samples"])
def test_cli_file_modes_write_the_jax_cli_files(tree, tmp_path, mode):
    argv = lambda dst: ["-f", mode, "-r", str(tree), "-s", "st", "-t", str(tmp_path / dst)]
    run_jax_cli(argv("jax"))
    run(cli.main, argv("port") + ["--cpu"])

    def listing(d):
        return {os.path.relpath(os.path.join(p, f), d): open(os.path.join(p, f), "rb").read()
                for p, _, fs in os.walk(d) for f in fs}

    got, want = listing(tmp_path / "port"), listing(tmp_path / "jax")
    assert got == want and len(got) == (3 * DRAWS if mode == "rename_samples" else 3)


@pytest.mark.parametrize("mode", ["LPIPS", "max_min_LPIPS", "FID"])
def test_cli_without_cpu_and_without_a_card_raises(tree, monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(mode_argv(tree, mode))
