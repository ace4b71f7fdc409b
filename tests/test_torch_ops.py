"""The port's three kernel-bearing ops against the JAX package's Pallas kernels.

CPU cases: each Pallas kernel runs in interpret mode (the Pallas functions pick
it themselves off-TPU) on numpy-seeded fp32 inputs and is held against the
port's plain twin; inputs are transposed NHWC <-> NCHW at the boundary.

GPU cases (marker ``gpu``, skipped without a card): each hand-written kernel
against its twin on the card in bf16 (K2 and K3 also in fp32, K3 also with
keys != queries), with its launch counter. They import no
jax, so on a machine without jax they run with
``python -m pytest tests/test_torch_ops.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from bbdm_tpu_torch.ops import attention, group_norm, upsample_conv
from chip_smoke import k1_grad_excess  # K1's backward against the twin: the smoke's bars

# fp32 bars: both sides sum the same products in another order (per-channel
# then per-group sums vs. one pass; 2x2 phase taps vs. 3x3 taps over an
# upsampled grid; blockwise online softmax vs. one softmax), so they agree to a
# few fp32 ulps of values of order 1, not bit for bit.
FP32_ATOL = 2e-5
FP32_RTOL = 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


# --------------------------------------------------------------- GroupNorm (K1)

@pytest.mark.parametrize("film,act,eps", [(False, None, 1e-5), (False, "silu", 1e-6),
                                          (True, "silu", 1e-5)])
def test_group_norm_pallas_matches_twin(film, act, eps):
    import jax.numpy as jnp
    from bbdm_tpu.ops.group_norm_pallas import group_norm_pallas

    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 8, 128).astype(np.float32) * 2 + 0.5
    scale = (1 + 0.1 * rs.randn(128)).astype(np.float32)
    bias = (0.1 * rs.randn(128)).astype(np.float32)
    fs = (0.1 * rs.randn(2, 128)).astype(np.float32) if film else None
    fb = (0.1 * rs.randn(2, 128)).astype(np.float32) if film else None
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = group_norm_pallas(j(x), j(scale), j(bias), j(fs), j(fb), 32, eps, act)
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = group_norm.group_norm(nchw(x), t(scale), t(bias), num_groups=32, eps=eps, act=act,
                                film_scale=t(fs), film_shift=t(fb))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=FP32_RTOL, atol=FP32_ATOL)


@pytest.mark.parametrize("C", [640, 96])
def test_group_norm_twin_matches_xla_for_channels_off_128(C):
    """C=640 (on the LBBDM-f4 path, 20 channels per group) and C=96, which the
    Pallas kernel's ``eligible`` refuses (C % 128 != 0), against the XLA
    formulation that the JAX package dispatches to by default."""
    from bbdm_tpu.ops.group_norm import _group_norm_xla

    rs = np.random.RandomState(1)
    x = rs.randn(2, 4, 4, C).astype(np.float32)
    scale, bias = rs.randn(C).astype(np.float32), rs.randn(C).astype(np.float32)
    ref = _group_norm_xla(x, scale, bias, num_groups=32, eps=1e-5, act="silu")
    out = group_norm.group_norm(nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                                act="silu")
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=FP32_RTOL, atol=FP32_ATOL)


# ------------------------------------------------------ subpixel up-conv (K2)

def test_combine_kernel_2x2_matches_jax():
    from bbdm_tpu.ops.subpixel_pallas import arrange_phase_kernel
    from bbdm_tpu.ops.upsample_conv import combine_kernel_2x2 as jax_combine

    w = np.random.RandomState(2).randn(3, 3, 16, 24).astype(np.float32)  # HWIO
    ref = np.asarray(arrange_phase_kernel(jax_combine(w)))  # [4, 2, 2, ci, co]
    out = upsample_conv.combine_kernel_2x2(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(out.numpy(), ref.transpose(0, 1, 2, 4, 3))


def test_subpixel_pallas_matches_twin():
    import jax.numpy as jnp
    from bbdm_tpu.ops.subpixel_pallas import arrange_phase_kernel, subpixel_upconv_pallas
    from bbdm_tpu.ops.upsample_conv import combine_kernel_2x2 as jax_combine

    rs = np.random.RandomState(3)
    x = rs.randn(1, 8, 8, 128).astype(np.float32)
    w = (rs.randn(3, 3, 128, 128) * 0.05).astype(np.float32)
    b = rs.randn(128).astype(np.float32)
    kp = arrange_phase_kernel(jax_combine(jnp.asarray(w)))
    ref = subpixel_upconv_pallas(jnp.asarray(x), kp, jnp.asarray(b))
    out = upsample_conv.upsample2x_conv3x3(
        nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=FP32_RTOL, atol=1e-4)


def test_transposed_conv_yardstick_computes_the_upconv():
    """chip_smoke.py times F.conv_transpose2d with the 4x4 kernel of
    ``upconv_transposed_kernel`` beside K2; it must be the same function as
    nearest-2x + padded 3x3 conv (fp32, so only the summation order differs)."""
    import torch.nn.functional as F

    from chip_smoke import upconv_transposed_kernel

    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(2, 5, 6, 7).astype(np.float32))
    w = torch.from_numpy(rs.randn(4, 5, 3, 3).astype(np.float32))
    b = torch.from_numpy(rs.randn(4).astype(np.float32))
    out = F.conv_transpose2d(x, upconv_transposed_kernel(w), b, stride=2, padding=1)
    ref = upsample_conv.upsample_conv_plain(x, w, b)
    assert out.shape == ref.shape == (2, 4, 12, 14)
    torch.testing.assert_close(out, ref, rtol=FP32_RTOL, atol=FP32_ATOL)


def phase_conv(x, kp, b):
    """The formula of K2's kernels, written out: out[n, o, 2i+py, 2j+px] =
    b[o] + sum_{r,s,c} kp[2py+px, r, s, o, c] * x[n, c, i+py-1+r, j+px-1+s],
    zero outside x."""
    N, ci, h, w = x.shape
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = torch.zeros(N, kp.shape[3], 2 * h, 2 * w)
    for py in (0, 1):
        for px in (0, 1):
            acc = b[None, :, None, None].expand(N, -1, h, w).clone()
            for r in (0, 1):
                for s in (0, 1):
                    win = xp[:, :, py + r:py + r + h, px + s:px + s + w]
                    acc += torch.einsum("oc,nchw->nohw", kp[2 * py + px, r, s], win)
            out[:, :, py::2, px::2] = acc
    return out


@pytest.mark.parametrize("shape,co", [((2, 8, 5, 7), 6), ((1, 3, 4, 4), 130)])
def test_phase_formula_of_the_kernels_is_the_upconv(shape, co):
    """The kernels' contract on the CPU: the phase kernel of
    ``combine_kernel_2x2`` in the [4, 2, 2, co, ci] layout the wrapper hands
    them, read at source offsets (py-1+r, px-1+s), is the nearest-2x + 3x3 conv
    (fp32 sums in another order)."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    w = torch.from_numpy(rs.randn(co, shape[1], 3, 3).astype(np.float32))
    b = torch.from_numpy(rs.randn(co).astype(np.float32))
    out = phase_conv(x, upsample_conv.combine_kernel_2x2(w), b)
    torch.testing.assert_close(out, upsample_conv.upsample_conv_plain(x, w, b),
                               rtol=FP32_RTOL, atol=FP32_ATOL)


@pytest.fixture
def kernels_as_twins(monkeypatch):
    """Both dispatchers take their kernel branch on the CPU; the "kernels"
    record the tensors they are handed and compute the twin."""
    calls = []

    def k2(x, kp, b):
        calls.append(("K2", x, kp, b))
        return phase_conv(x, kp, b)

    def k3(q, k, v):
        calls.append(("K3", q, k, v))
        return attention.attention_plain(q, k, v)

    for mod in (attention, upsample_conv):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
    monkeypatch.setattr(upsample_conv, "upsample_conv_cuda", k2)
    monkeypatch.setattr(attention, "flash_attention_cuda", k3)
    return calls


def test_fp32_goes_to_the_kernels(kernels_as_twins):
    """An fp32 model hands K2 fp32 x, phase kernel and bias (no bf16 cast), and
    K3 its fp32 q, k, v at T >= 1024, D % 128 == 0; with grad through the
    Function, whose backward is the twin's."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.randn(1, 16, 6, 6).astype(np.float32))
    w = torch.from_numpy(rs.randn(8, 16, 3, 3).astype(np.float32))
    b = torch.from_numpy(rs.randn(8).astype(np.float32))
    out = upsample_conv.upsample2x_conv3x3(x, w, b)
    name, xk, kp, bk = kernels_as_twins[-1]
    assert name == "K2" and {xk.dtype, kp.dtype, bk.dtype} == {torch.float32}
    assert kp.shape == (4, 2, 2, 8, 16) and kp.is_contiguous() and xk.is_contiguous()
    torch.testing.assert_close(out, upsample_conv.upsample_conv_plain(x, w, b),
                               rtol=FP32_RTOL, atol=FP32_ATOL)

    q, k, v = (torch.from_numpy(rs.randn(1, 1, 1024, 128).astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = attention.multi_head_attention(q, k, v)
    assert kernels_as_twins[-1][0] == "K3" and kernels_as_twins[-1][1].dtype == torch.float32
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    g = torch.from_numpy(rs.randn(*out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(attention.attention_plain(q, k, v), (q, k, v), g)
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    assert len(kernels_as_twins) == 2


@pytest.mark.parametrize("case", ["k2-grad", "k2-cpu", "k2-kernel-dtype", "k3-cpu",
                                  "k3-mixed"])
def test_kernel_wrappers_refuse_what_they_do_not_take(case):
    """They raise before any launch: K2 on inputs that require grad (it has no
    backward), a tensor off the card, or a phase kernel not in x's dtype; K3 off
    the card or with q, k, v of mixed dtypes."""
    x, kp, b = torch.zeros(1, 8, 4, 4), torch.zeros(4, 2, 2, 8, 8), torch.zeros(8)
    q = torch.zeros(1, 1, 64, 64)
    run = {
        "k2-grad": lambda: upsample_conv.upsample_conv_cuda(x.requires_grad_(), kp, b),
        "k2-cpu": lambda: upsample_conv.upsample_conv_cuda(x, kp, b),
        "k2-kernel-dtype": lambda: upsample_conv.upsample_conv_cuda(x, kp.bfloat16(), b),
        "k3-cpu": lambda: attention.flash_attention_cuda(q, q, q),
        "k3-mixed": lambda: attention.flash_attention_cuda(q, q.bfloat16(), q),
    }[case]
    with pytest.raises(RuntimeError if case == "k2-grad" else ValueError):
        run()


# ------------------------------------------------------ flash attention (K3)

def test_flash_attention_pallas_matches_twin():
    import jax.numpy as jnp
    from bbdm_tpu.ops.flash_attention import flash_attention

    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(1, 2, 512, 128).astype(np.float32) for _ in range(3))
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = attention.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FP32_RTOL, atol=FP32_ATOL)


def test_attention_twin_matches_xla_in_bf16():
    """The twin rounds where ``_xla_attention`` rounds: scaled q/k and the
    softmax weights in the input dtype, fp32 products."""
    import jax.numpy as jnp
    from bbdm_tpu.ops.attention import _xla_attention

    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 4, 64, 32).astype(np.float32) for _ in range(3))
    ref = _xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    out = attention.attention_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    # XLA's and torch's exp differ by fp32 ulps, so a softmax weight can round
    # to the neighbouring bf16 value; outputs of order 1 then differ by up to
    # two bf16 ulps (2^-7 each)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=2 ** -6)


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("shape,film,eps,dtype", [
    ((2, 640, 16, 16), False, 1e-5, torch.bfloat16),
    ((2, 256, 32, 32), True, 1e-5, torch.bfloat16),
    ((1, 128, 64, 64), False, 1e-6, torch.float32),
    # a cluster of 2 (VQGAN 128 channels at 128^2), of 8 (the decoder's largest norm)
    ((2, 128, 128, 128), False, 1e-6, torch.bfloat16),
    ((2, 256, 256, 256), False, 1e-6, torch.bfloat16),
    # a span that overflows a cluster of 8 (fp32 at 256^2: 2 MB, 256 KB per CTA)
    ((1, 256, 256, 256), False, 1e-6, torch.float32),
    # a ragged span (105 elements: vector loads with scalar edges), fp16 with FiLM,
    # a cluster of 4, and a ragged span split over a cluster of 2
    ((2, 96, 7, 5), False, 1e-5, torch.bfloat16),
    ((2, 320, 24, 24), True, 1e-5, torch.float16),
    ((2, 256, 128, 128), False, 1e-6, torch.bfloat16),
    ((2, 32, 255, 255), True, 1e-6, torch.bfloat16),
])
def test_group_norm_kernel_matches_twin(cuda, shape, film, eps, dtype):
    g = torch.Generator(cuda).manual_seed(0)
    N, C = shape[:2]
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = 1 + 0.1 * torch.randn(C, generator=g, device=cuda)
    b = 0.1 * torch.randn(C, generator=g, device=cuda)
    f = (0.1 * torch.randn(N, 2 * C, generator=g, device=cuda)).to(dtype) if film else None
    fs, fb = f.chunk(2, dim=1) if film else (None, None)
    before = group_norm.group_norm_cuda.launches
    out = group_norm.group_norm(x, w, b, eps=eps, act="silu", film_scale=fs, film_shift=fb)
    ref = group_norm.group_norm_plain(x, w, b, eps=eps, act="silu", film_scale=fs,
                                      film_shift=fb)
    torch.cuda.synchronize()
    assert group_norm.group_norm_cuda.launches == before + 1
    # fp32 arithmetic on both sides; 16-bit outputs may round one ulp apart
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def k1_grads(cuda, shape, film, dtype, film_dtype, act, eps, grad=(True,) * 4, seed=0):
    """(kernel's gradients, the twin's autograd gradients, the kernel's
    gradients again) of x, weight, bias and the [N, 2C] FiLM tensor whose halves
    are the scale and shift, for the inputs flagged in ``grad``."""
    g = torch.Generator(cuda).manual_seed(seed)
    N, C = shape[:2]
    x = (2 * torch.randn(shape, generator=g, device=cuda) + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(C, generator=g, device=cuda)
    b = 0.1 * torch.randn(C, generator=g, device=cuda)
    f = (0.1 * torch.randn(N, 2 * C, generator=g, device=cuda)).to(film_dtype)
    dy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    leaves = [t.requires_grad_(r) for t, r in zip((x, w, b, f), grad)]
    wanted = [t for t in leaves[:4 if film else 3] if t.requires_grad]

    def run(fn):
        fs, fb = f.chunk(2, dim=1) if film else (None, None)
        out = fn(x, w, b, eps=eps, act=act, film_scale=fs, film_shift=fb)
        return torch.autograd.grad(out, wanted, dy)

    got = run(group_norm.group_norm)
    return got, run(group_norm.group_norm_plain), run(group_norm.group_norm)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,film,dtype,film_dtype,act,eps", [
    # a cluster of 1, 2 (FiLM in fp32), 4 and 8; the UNet's shapes
    ((2, 128, 32, 32), True, torch.bfloat16, torch.bfloat16, "silu", 1e-5),
    ((2, 1024, 32, 32), True, torch.bfloat16, torch.float32, "silu", 1e-5),
    ((2, 640, 64, 64), False, torch.bfloat16, torch.bfloat16, "silu", 1e-5),
    ((1, 256, 128, 128), False, torch.bfloat16, torch.bfloat16, None, 1e-6),
    # spans that overflow a cluster of 8 (bf16 and fp32 at 256^2)
    ((2, 256, 256, 256), False, torch.bfloat16, torch.bfloat16, "silu", 1e-6),
    ((1, 256, 256, 256), False, torch.float32, torch.float32, "silu", 1e-6),
    # fp32 (VQGAN training), the transformer's norm (no SiLU, eps 1e-6)
    ((1, 128, 64, 64), False, torch.float32, torch.float32, None, 1e-6),
    ((2, 512, 32, 32), False, torch.bfloat16, torch.bfloat16, None, 1e-6),
    # hw not a multiple of a 16-byte vector (one element an access), on one CTA
    # and over a cluster of 4; fp16 with FiLM
    ((2, 96, 7, 5), True, torch.bfloat16, torch.bfloat16, "silu", 1e-5),
    ((2, 32, 255, 255), True, torch.bfloat16, torch.bfloat16, "silu", 1e-6),
    ((2, 320, 24, 24), True, torch.float16, torch.float16, "silu", 1e-5),
])
def test_group_norm_backward_kernel_matches_twin(cuda, shape, film, dtype, film_dtype, act, eps):
    before = group_norm.group_norm_bwd_cuda.launches
    got, ref, again = k1_grads(cuda, shape, film, dtype, film_dtype, act, eps)
    torch.cuda.synchronize()
    assert group_norm.group_norm_bwd_cuda.launches == before + 2  # one call a backward
    assert k1_grad_excess(got, ref) <= 1
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("grad", [(True, False, False, False), (False, True, True, False),
                                  (False, False, False, True)])
def test_group_norm_backward_kernel_computes_only_what_is_asked(cuda, grad):
    got, ref, _ = k1_grads(cuda, (2, 256, 32, 32), True, torch.bfloat16, torch.bfloat16, "silu",
                           1e-5, grad=grad)
    torch.cuda.synchronize()
    assert len(got) == sum(grad)
    assert k1_grad_excess(got, ref, dx=grad[0]) <= 1


@pytest.mark.gpu
def test_group_norm_backward_on_cuda_never_recomputes(cuda, monkeypatch):
    import bbdm_tpu_torch.ops as ops

    def refuse(*a, **kw):
        raise AssertionError("K1's backward reached recompute_grads")

    monkeypatch.setattr(ops, "recompute_grads", refuse)
    got, ref, _ = k1_grads(cuda, (2, 256, 16, 16), True, torch.bfloat16, torch.bfloat16, "silu",
                           1e-5)
    assert k1_grad_excess(got, ref) <= 1
    assert not hasattr(group_norm, "recompute_grads")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,co", [((2, 64, 16, 16), 64), ((1, 32, 24, 40), 96),
                                      ((1, 20, 5, 7), 30)])
def test_upsample_conv_kernel_matches_twin(cuda, shape, co):
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda).bfloat16()
    w = 0.05 * torch.randn(co, shape[1], 3, 3, generator=g, device=cuda)
    b = torch.randn(co, generator=g, device=cuda)
    before = upsample_conv.upsample_conv_cuda.launches
    out = upsample_conv.upsample2x_conv3x3(x, w, b, dtype=torch.bfloat16)
    ref = upsample_conv.upsample_conv_plain(x.float(), w, b)
    torch.cuda.synchronize()
    assert upsample_conv.upsample_conv_cuda.launches == before + 1
    # bf16 phase kernel and output rounding (2^-8 relative each), fp32 sums
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1, 1024, 512), (1, 2, 1100, 128)])
def test_flash_attention_kernel_matches_twin(cuda, shape):
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(3))
    before = attention.flash_attention_cuda.launches
    out = attention.multi_head_attention(q, k, v)
    ref = attention.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == before + 1
    # bf16 probabilities and output on both sides, rounded at different places
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_flash_attention_kernel_pads_shapes_below_one_box(cuda):
    """T and D below K3's 64 x 64 TMA box: the wrapper zero-pads, masks and cuts."""
    g = torch.Generator(cuda).manual_seed(3)
    q, k, v = (torch.randn((1, 1, 50, 48), generator=g, device=cuda).bfloat16() for _ in range(3))
    out = attention.flash_attention_cuda(q, k, v)
    ref = attention.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,co", [((2, 64, 16, 16), 64), ((1, 32, 24, 40), 96),
                                      ((1, 20, 5, 7), 30), ((1, 512, 16, 16), 512)])
def test_upsample_conv_kernel_matches_twin_fp32(cuda, shape, co):
    g = torch.Generator(cuda).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda)
    w = 0.05 * torch.randn(co, shape[1], 3, 3, generator=g, device=cuda)
    b = torch.randn(co, generator=g, device=cuda)
    before = upsample_conv.upsample_conv_cuda.launches
    out = upsample_conv.upsample2x_conv3x3(x, w, b)
    ref = upsample_conv.upsample_conv_plain(x, w, b)
    torch.cuda.synchronize()
    assert upsample_conv.upsample_conv_cuda.launches == before + 1 and out.dtype == torch.float32
    # 3xTF32 products (~2^-22 each) against fp32 FMAs (TF32 off), summed in
    # another order
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1, 1024, 512), (1, 2, 1100, 128), (1, 1, 50, 48)])
def test_flash_attention_kernel_matches_twin_fp32(cuda, shape):
    g = torch.Generator(cuda).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    before = attention.flash_attention_cuda.launches
    out = attention.flash_attention_cuda(q, k, v)
    ref = attention.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == before + 1 and out.dtype == torch.float32
    # 3xTF32 products against fp32 FMAs (TF32 off), fp32 softmax on both sides,
    # an online softmax vs one pass
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1e-3, 1e2])
def test_upsample_conv_kernel_fp32_keeps_both_halves_at_any_scale(cuda, scale):
    """x and the bias scaled: the output scales with them, and so must the
    kernel's agreement with the twin. A split that lost lo would miss here."""
    g = torch.Generator(cuda).manual_seed(6)
    x = scale * torch.randn((2, 256, 16, 16), generator=g, device=cuda)
    w = 0.02 * torch.randn(256, 256, 3, 3, generator=g, device=cuda)
    b = scale * torch.randn(256, generator=g, device=cuda)
    out = upsample_conv.upsample2x_conv3x3(x, w, b)
    ref = upsample_conv.upsample_conv_plain(x, w, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1e-3, 1e2])
def test_flash_attention_kernel_fp32_keeps_both_halves_at_any_scale(cuda, scale):
    """q, k and v scaled by 1e-3 (flat logits), or v by 1e2 (q and k scaled by
    1e2 would put the logits near 1e4, where the softmax turns on near ties
    that fp32 itself rounds either way): the output scales with v."""
    g = torch.Generator(cuda).manual_seed(7)
    qk = min(scale, 1.0)
    q, k = (qk * torch.randn((1, 2, 1024, 512), generator=g, device=cuda) for _ in range(2))
    v = scale * torch.randn((1, 2, 1024, 512), generator=g, device=cuda)
    out = attention.flash_attention_cuda(q, k, v)
    ref = attention.attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,tk", [((2, 4, 1024, 128), 4096), ((2, 4, 1024, 128), 1),
                                      ((1, 2, 1100, 128), 77), ((1, 1, 50, 48), 3)])
def test_flash_attention_kernel_with_other_key_count_matches_twin(cuda, dtype, shape, tk):
    """keys != queries (cross-attention; Tk 1: a class embedding's context)."""
    if dtype == torch.bfloat16 and shape[-1] % 16:
        pytest.skip("bf16 K3 takes D % 16 == 0")
    g = torch.Generator(cuda).manual_seed(8)
    q = torch.randn(shape, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((*shape[:2], tk, shape[3]), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = attention.flash_attention_cuda.launches
    out = attention.flash_attention_cuda(q, k, v)
    ref = attention.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == before + 1 and out.shape == q.shape
    # the bars of the Tk == Tq cases above
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("tq,d", [(4096, 40), (1024, 80), (256, 160)])
def test_flash_attention_kernel_takes_the_unet_head_dims(cuda, tq, d):
    """The SD v1 widths' heads (8 x 40, 80, 160 over 4096 context keys), which
    the dispatch sends to K3 in bf16: within the bf16 bar of the twin, with
    no [Tq, Tk] logits allocated (the peak rises by less than one head's
    bf16 logits: K3 holds only q, k, v padded to 64 columns and the output)."""
    g = torch.Generator(cuda).manual_seed(9)
    q = torch.randn((1, 8, tq, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((1, 8, 4096, d), generator=g, device=cuda).bfloat16() for _ in range(2))
    assert attention.flash_route(tq, 4096, d, torch.bfloat16)
    ref = attention.attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    before = attention.flash_attention_cuda.launches
    out = attention.multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == before + 1 and out.shape == q.shape
    assert torch.cuda.max_memory_allocated(cuda) - base < tq * 4096 * 2
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
