"""The 3xTF32 arithmetic of the fp32 K2 and K3 kernels, on the CPU.

The fp32 kernels (``csrc/subpixel_upconv_f32.cu``, ``csrc/flash_attention_f32.cu``)
split each operand as x = hi + lo with ``ops.split_tf32`` (hi = tf32(x),
lo = tf32(x - hi), round to nearest with ties away, as ``cvt.rna.tf32.f32``)
and multiply on the TF32 tensor cores as lo*hi + hi*lo + hi*hi with fp32 sums.
The kernels run only on the card; here their arithmetic is emulated in fp32
(products of TF32 values are exact in fp32) and held against the JAX package's
functions under the bars ``chip_smoke.py`` holds the kernels to:
K3 fp32 1e-5 + 1e-4|ref|, K2 fp32 1e-4 + 1e-4|ref|. 3xTF32 stays within a fifth
of each bar (2-5% of it at these seeds); one TF32 pass (hi only) misses the
same bars by more than 5x (7-20x here): that is what makes the split
necessary.
"""

import numpy as np
import pytest
import torch

from bbdm_tpu_torch.ops import split_tf32, tf32_round, upsample_conv

K3_BAR = (1e-5, 1e-4)  # (atol, rtol)
K2_BAR = (1e-4, 1e-4)


def excess(out, ref, bar):
    """max |out - ref| / (atol + rtol |ref|): <= 1 within the bar."""
    atol, rtol = bar
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(out - ref) / (atol + rtol * np.abs(ref))).max())


def tf32_matmul(a, b, passes):
    """a @ b with TF32 operands: 3 passes lo*hi + hi*lo + hi*hi, or hi*hi alone."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def attention_tf32(q, k, v, passes):
    """K3 fp32's arithmetic: q and k times D^-1/4 in fp32, both products in TF32
    passes, an fp32 softmax."""
    scale = 1.0 / (q.shape[-1] ** 0.25)
    logits = tf32_matmul(q * scale, (k * scale).transpose(-1, -2), passes)
    return tf32_matmul(torch.softmax(logits, dim=-1), v, passes)


def upconv_tf32(x, kp, b, passes):
    """K2 fp32's arithmetic: out[n, o, 2i+py, 2j+px] = b[o] + sum over taps (r, s)
    and c of kp[2py+px, r, s, o, c] x[n, c, i+py-1+r, j+px-1+s] (zero outside x),
    each product in TF32 passes."""
    N, ci, h, w = x.shape
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = torch.zeros(N, kp.shape[3], 2 * h, 2 * w)
    for py in (0, 1):
        for px in (0, 1):
            acc = b[None, :, None, None].expand(N, -1, h, w).clone()
            for r in (0, 1):
                for s in (0, 1):
                    win = xp[:, :, py + r:py + r + h, px + s:px + s + w]
                    cols = win.permute(0, 2, 3, 1).reshape(-1, ci)  # [N h w, ci]
                    prod = tf32_matmul(cols, kp[2 * py + px, r, s].T, passes)
                    acc += prod.reshape(N, h, w, -1).permute(0, 3, 1, 2)
            out[:, :, py::2, px::2] = acc
    return out


# ---------------------------------------------------------------- the split

def values(kind):
    rs = np.random.RandomState(11)
    x = rs.randn(4096).astype(np.float32)
    if kind == "wide":  # magnitudes 2^-60 ... 2^60
        x = x * np.exp2(rs.randint(-60, 60, x.size)).astype(np.float32)
    elif kind == "ties":  # the 13 low bits exactly half way: rounding goes away from 0
        bits = x.view(np.int32) & ~np.int32(0x1FFF) | np.int32(0x1000)
        x = bits.view(np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
def test_split_reconstructs_within_2_to_the_minus_22(kind):
    x = values(kind)
    hi, lo = split_tf32(x)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
    # and hi alone is one TF32 rounding: within 2^-11, not 2^-22
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
def test_split_halves_have_13_zero_low_bits(kind):
    x = values(kind)
    hi, lo = split_tf32(x)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    if kind == "ties":  # round to nearest, ties away from zero (cvt.rna)
        away = (x.abs().view(torch.int32) + 0x1000) & -0x2000
        assert torch.equal(hi.abs().view(torch.int32), away)
    assert torch.equal(tf32_round(hi), hi)


# ---------------------------------------------------- attention (K3 fp32)

def attention_case(shape):
    """Inputs made from a numpy seed and the JAX package's answer: its Pallas
    ``flash_attention`` in interpret mode (as its own tests run it) where T
    tiles its blocks, else ``_xla_attention``, both in fp32."""
    import jax.numpy as jnp
    from bbdm_tpu.ops.attention import _xla_attention
    from bbdm_tpu.ops.flash_attention import flash_attention

    rs = np.random.RandomState(12)
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    fn = flash_attention if shape[2] % 256 == 0 else _xla_attention
    ref = np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v))))
    return [torch.from_numpy(a) for a in (q, k, v)], ref


@pytest.mark.parametrize("shape", [(1, 1, 256, 512), (1, 1, 1100, 128)])
def test_attention_in_3xtf32_is_within_the_fp32_bar(shape):
    (q, k, v), ref = attention_case(shape)
    assert excess(attention_tf32(q, k, v, passes=3), ref, K3_BAR) <= 0.2


@pytest.mark.parametrize("shape", [(1, 1, 256, 512), (1, 1, 1100, 128)])
def test_attention_in_one_tf32_pass_misses_the_fp32_bar(shape):
    (q, k, v), ref = attention_case(shape)
    assert excess(attention_tf32(q, k, v, passes=1), ref, K3_BAR) > 5


# ------------------------------------------------- subpixel up-conv (K2 fp32)

def upconv_case(shape, co):
    """The JAX package's ``subpixel_upconv_pallas`` (interpret mode) on
    numpy-seeded x, 3x3 weights and bias; the port's phase kernel of the same
    weights in the layout the kernel takes."""
    import jax.numpy as jnp
    from bbdm_tpu.ops.subpixel_pallas import arrange_phase_kernel, subpixel_upconv_pallas
    from bbdm_tpu.ops.upsample_conv import combine_kernel_2x2 as jax_combine

    N, ci, h, w = shape
    rs = np.random.RandomState(13)
    x = rs.randn(N, h, w, ci).astype(np.float32)  # NHWC, as the JAX package
    wt = (rs.randn(3, 3, ci, co) * 0.02).astype(np.float32)  # HWIO
    b = (rs.randn(co) * 0.1).astype(np.float32)
    ref = subpixel_upconv_pallas(jnp.asarray(x), arrange_phase_kernel(jax_combine(jnp.asarray(wt))),
                                 jnp.asarray(b))
    kp = upsample_conv.combine_kernel_2x2(torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()))
    x_nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return (x_nchw, kp, torch.from_numpy(b)), np.asarray(ref).transpose(0, 3, 1, 2)


# ci = 128 (four 32-channel stages per tap), and ci = 200 (a ragged last stage)
# at a ragged 5 x 7
UPCONV_SHAPES = [((1, 128, 8, 8), 128), ((1, 200, 5, 7), 40)]


@pytest.mark.parametrize("shape,co", UPCONV_SHAPES)
def test_upconv_in_3xtf32_is_within_the_fp32_bar(shape, co):
    args, ref = upconv_case(shape, co)
    assert excess(upconv_tf32(*args, passes=3), ref, K2_BAR) <= 0.2


@pytest.mark.parametrize("shape,co", UPCONV_SHAPES)
def test_upconv_in_one_tf32_pass_misses_the_fp32_bar(shape, co):
    args, ref = upconv_case(shape, co)
    assert excess(upconv_tf32(*args, passes=1), ref, K2_BAR) > 5
