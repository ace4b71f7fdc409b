"""The port's metric CLI (``preprocess_and_evaluation_torch.py``) over a tree
of JPEG and BMP files against the JAX CLI, which reads them with Pillow: ``-f
psnr_ssim`` over JPEG ground truth and BMP samples, ``-f diversity`` over draws
stored as JPEG (in files named ``output_<j>.png``, as the protocol names them;
both readers go by the file's signature). The same float64 numpy runs on the
same pixels, so the printed values agree to 1e-12. (``-f FID`` is left to
``test_torch_eval_metrics.py``: each side costs a 2048^2 ``sqrtm``.)"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from bbdm_tpu_torch.evaluation import cli
from tests.data.torch_images.make_fixtures import textured
from tests.test_torch_eval_metrics import number, run, run_jax_cli

N, DRAWS, SIZE = 4, 2, 40


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("formats")
    rs = np.random.RandomState(1)
    for d in ("gt", "flat", "data"):
        os.makedirs(root / d)
    for i in range(N):
        Image.fromarray(textured(SIZE, SIZE, 3, rs.randint(1 << 20))).save(
            root / "gt" / f"{i}.jpg", quality=85, subsampling=i % 3)
        Image.fromarray(textured(SIZE, SIZE, 3, rs.randint(1 << 20))).convert(
            "P" if i % 2 else "RGB").save(root / "flat" / f"{i}.jpg", format="BMP")
        os.makedirs(root / "data" / str(i))
        for j in range(DRAWS):
            b = io.BytesIO()
            Image.fromarray(textured(SIZE, SIZE, 3, rs.randint(1 << 20))).save(
                b, format="JPEG", quality=80, progressive=bool(j))
            (root / "data" / str(i) / f"output_{j}.png").write_bytes(b.getvalue())
    return root


@pytest.mark.parametrize("mode", ["psnr_ssim", "diversity"])
def test_cli_over_jpeg_and_bmp_files_prints_the_jax_cli_value(tree, mode):
    argv = {"psnr_ssim": ["-f", "psnr_ssim", "-s", f"{tree}/flat", "-t", f"{tree}/gt"],
            "diversity": ["-f", "diversity", "-s", f"{tree}/data", "-n", str(DRAWS)]}[mode]
    got, want = run(cli.main, argv + ["--cpu"]), run_jax_cli(argv)
    label = {"psnr_ssim": "(?:PSNR|SSIM|MSE)", "diversity": "diversity"}[mode]
    a, b = number(got, label), number(want, label)
    assert a and len(a) == len(b), (got, want)
    assert a == pytest.approx(b, rel=1e-12)
    assert got == want  # the same numpy on the same pixels: the same text
