"""Offline evaluation (port of ``bbdm_tpu/evaluation/`` and
``preprocess_and_evaluation.py``): FID, LPIPS and diversity over the
``sample_to_eval`` directory contract, plus weights-free pixel metrics.

The backbones (FID InceptionV3, LPIPS AlexNet/VGG16) load weights the user
supplies (``BBDM_FID_WEIGHTS`` / ``BBDM_LPIPS_WEIGHTS`` or function arguments):
pytorch_fid's and lpips's torch state dicts load as they are, the JAX package's
converted trees through the converters. Nothing is downloaded. The networks run
on the CUDA card unless the caller asks for the CPU; diversity and PSNR/SSIM/MSE
are numpy. Images are 8-bit PNG, read without Pillow.
"""

from bbdm_tpu_torch.evaluation.diversity import calc_diversity  # noqa: F401
from bbdm_tpu_torch.evaluation.fid import calc_FID, frechet_distance  # noqa: F401
from bbdm_tpu_torch.evaluation.pixel_metrics import calc_psnr_ssim  # noqa: F401
