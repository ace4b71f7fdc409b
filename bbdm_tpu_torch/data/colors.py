"""OpenCV's 8-bit colour conversion and resize in numpy, for the
``custom_colorization_LAB`` dataset (``bbdm_tpu/data/custom.py:120-161`` reads
with ``cv2.imread``, then ``cvtColor(COLOR_BGR2LAB)``, ``flip`` and ``resize``).

These are OpenCV's integer algorithms for uint8 images, not the textbook float
formulas, which differ from them by up to 2 levels:

* :func:`rgb_to_lab`: ``cvtColor(..., COLOR_BGR2LAB)`` on 8-bit input
  (``imgproc/src/color_lab.cpp``, ``RGB2Lab_b``): an sRGB gamma table of 256
  entries in 3 fractional bits, the sRGB -> XYZ (D65) matrix over the white
  point in 12-bit fixed point, a cube-root table of 3072 entries in 15-bit
  fixed point, and L, a, b in fixed point. OpenCV builds its tables in
  software floats; its float32 cube root rounds toward zero, which decides the
  table entries that fall on a tie.
* :func:`resize_linear`: ``cv2.resize(..., interpolation=INTER_LINEAR)`` on
  uint8 (``imgproc/src/resize.cpp``): source coordinate ``(d + 0.5) * in / out
  - 0.5``, weights in 11-bit fixed point, a horizontal pass into int32, then a
  vertical pass in 16-bit products rounded as OpenCV's vector code rounds
  them; no antialiasing. Where both axes shrink by exactly 2, OpenCV averages
  2x2 blocks instead.

The tests hold both against cv2 (all 2^24 colours; up-, down- and non-square
resizes).
"""

from __future__ import annotations

import functools

import numpy as np

_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                         [0.212671, 0.715160, 0.072169],
                         [0.019334, 0.119193, 0.950227]])
_D65 = np.array([0.950456, 1.0, 1.088754])


def _cv_round(x) -> np.ndarray:
    return np.rint(x).astype(np.int64)  # cvRound: to nearest, ties to even


def _cbrt_toward_zero(x: np.ndarray) -> np.ndarray:
    """float32 cube root of float32 x > 0, rounded toward zero."""
    exact = np.cbrt(x.astype(np.float64))
    y = exact.astype(np.float32)
    return np.where(y.astype(np.float64) > exact, np.nextafter(y, np.float32(0)), y)


@functools.lru_cache(maxsize=1)
def _lab_tables():
    """(gamma table [256], cube-root table [3072], coefficients [3, 3]) of
    OpenCV's ``initLabTabs`` and ``RGB2Lab_b``."""
    f32 = np.float32
    x = (f32(np.arange(256)) / f32(255)).astype(np.float64)
    gamma = np.where(x <= 809 / 20000, x / (323 / 25),
                     ((x + 11 / 200) / (1 + 11 / 200)) ** (12 / 5)).astype(np.float32)
    gamma_tab = _cv_round(f32(255 * (1 << _GAMMA_SHIFT)) * gamma)
    xs = (f32(1) / (f32(255) * f32(1 << _GAMMA_SHIFT))
          * f32(np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT)))).astype(np.float32)
    lthresh, lscale, lbias = f32(216) / f32(24389), f32(841) / f32(108), f32(16) / f32(116)
    linear = (xs.astype(np.float64) * np.float64(lscale) + np.float64(lbias)).astype(np.float32)
    f = np.where(xs < lthresh, linear, _cbrt_toward_zero(xs))
    cbrt_tab = _cv_round(f32(1 << _LAB_SHIFT2) * f.astype(np.float32))
    coeffs = _cv_round((1 << _LAB_SHIFT) * _SRGB_TO_XYZ / _D65[:, None])
    return gamma_tab, cbrt_tab, coeffs


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] -> uint8 L, a, b [..., 3], as ``cv2.cvtColor`` of the
    same pixels in BGR order with ``COLOR_BGR2LAB``."""
    gamma_tab, cbrt_tab, c = _lab_tables()
    lin = gamma_tab[np.asarray(rgb, np.uint8)]
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    descale = lambda v, n: (v + (1 << (n - 1))) >> n
    fx, fy, fz = (cbrt_tab[descale(r * c[k, 0] + g * c[k, 1] + b * c[k, 2], _LAB_SHIFT)]
                  for k in range(3))
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    half = 128 * (1 << _LAB_SHIFT2)
    lab = np.stack([descale(l_scale * fy + l_shift, _LAB_SHIFT2),
                    descale(500 * (fx - fy) + half, _LAB_SHIFT2),
                    descale(200 * (fy - fz) + half, _LAB_SHIFT2)], axis=-1)
    return np.clip(lab, 0, 255).astype(np.uint8)


_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(in_size: int, out_size: int, clamp_weights: bool):
    """(first and second source index [out], their 11-bit fixed-point weights
    [out, 2]) of one axis. Horizontally OpenCV moves a source coordinate outside
    the image onto its edge pixel with weight 1 (``clamp_weights``); vertically
    it keeps the weights and repeats the edge row."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weights:
        f = np.where((s < 0) | (s >= in_size - 1), np.float32(0), f)
        s = np.clip(s, 0, in_size - 1)
    fixed = np.stack([_cv_round((np.float32(1) - f) * np.float32(_COEF_SCALE)),
                      _cv_round(f * np.float32(_COEF_SCALE))], axis=-1)
    return np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1), fixed


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [h, w, C] as ``cv2.resize(img, (w, h),
    interpolation=cv2.INTER_LINEAR)``."""
    img = np.asarray(img, np.uint8)
    H, W = img.shape[:2]
    h, w = size
    if (H, W) == (h, w):
        return img.copy()
    if H == 2 * h and W == 2 * w:  # OpenCV's INTER_AREA fast path for exactly half size
        blocks = img.reshape(h, 2, w, 2, -1).astype(np.int32).sum(axis=(1, 3))
        return ((blocks + 2) >> 2).astype(np.uint8)
    x0, x1, wx = _linear_taps(W, w, True)
    y0, y1, wy = _linear_taps(H, h, False)
    src = img.astype(np.int64)
    rows = src[:, x0] * wx[None, :, 0, None] + src[:, x1] * wx[None, :, 1, None]  # int32 in C
    # the vertical pass as OpenCV's vector code rounds it: each row's sum shifted
    # right by 4, times its 16-bit weight, the high 16 bits kept, then (s + 2) >> 2
    out = (((rows[y0] >> 4) * wy[:, 0, None, None]) >> 16) \
        + (((rows[y1] >> 4) * wy[:, 1, None, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
