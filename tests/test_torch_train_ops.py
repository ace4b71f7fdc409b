"""The kernels' autograd on the CPU: K1's and K3's autograd Functions against
the JAX package's VJPs, the dispatch that sends grad-requiring inputs through
them, K2's refusal of such inputs, and the two layers whose training form
differs from their eval form (the up-conv and dropout).

On the CPU no kernel runs: each test injects the plain versions in the
kernels' places (``group_norm_cuda`` / ``flash_attention_cuda`` replaced by
the twins, and K1's backward ``group_norm_bwd_cuda`` by
``group_norm_backward_plain``; K3's backward recomputes the twin). The JAX side
is the Pallas kernel in interpret mode (its ``custom_vjp`` backward recomputes
through XLA) and ``jax.vjp`` of the XLA formulation itself. fp32 bars: both
sides sum the same products in another order, so forward and gradients agree
to a few fp32 ulps of values of order 1 (rtol 1e-4, atol 2e-5; 1e-4 for summed
parameter gradients over N x H x W terms). K1's closed-form backward against
``jax.vjp`` differentiates another formula (XLA's autodiff goes through
E[x^2] - mean^2): 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbdm_tpu_torch.models import layers as tl
from bbdm_tpu_torch.ops import attention, group_norm, upsample_conv

RTOL, ATOL, SUM_ATOL = 1e-4, 2e-5, 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def counting(fn):
    def wrapper(*a, **kw):
        wrapper.launches += 1
        return fn(*a, **kw)

    wrapper.launches = 0
    return wrapper


@pytest.fixture
def twins_as_kernels(monkeypatch):
    """Every dispatcher takes its kernel branch on the CPU, with the twin as the
    kernel (a counting wrapper per kernel)."""
    for mod in (group_norm, attention, upsample_conv):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
    monkeypatch.setattr(group_norm, "group_norm_cuda", counting(group_norm.group_norm_plain))
    monkeypatch.setattr(attention, "flash_attention_cuda", counting(attention.attention_plain))
    monkeypatch.setattr(group_norm, "group_norm_bwd_cuda",
                        counting(group_norm.group_norm_backward_plain))
    return group_norm.group_norm_cuda, attention.flash_attention_cuda, \
        group_norm.group_norm_bwd_cuda


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_function_backward_matches_jax_vjp(twins_as_kernels, film, act):
    from bbdm_tpu.ops.group_norm import _group_norm_xla
    from bbdm_tpu.ops.group_norm_pallas import group_norm_pallas

    rs = np.random.RandomState(0)
    x = (rs.randn(2, 8, 8, 128) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(128)).astype(np.float32)
    bias = (0.1 * rs.randn(128)).astype(np.float32)
    fs, fb = ((0.1 * rs.randn(2, 128)).astype(np.float32) for _ in range(2))
    g = rs.randn(2, 8, 8, 128).astype(np.float32)
    args = [x, scale, bias] + ([fs, fb] if film else [])

    def xla(x, s, b, *f):
        return _group_norm_xla(x, s, b, num_groups=32, eps=1e-5, act=act,
                               film_scale=f[0] if f else None, film_shift=f[1] if f else None)

    def pallas(x, s, b, *f):
        return group_norm_pallas(x, s, b, f[0] if f else None, f[1] if f else None, 32,
                                 1e-5, act)

    leaves = [torch.from_numpy(a.transpose(0, 3, 1, 2).copy() if a.ndim == 4 else a.copy())
              .requires_grad_() for a in args]
    out = group_norm.GroupNormFunction.apply(*leaves[:3], *(leaves[3:] if film else [None] * 2),
                                             32, 1e-5, act)
    assert twins_as_kernels[0].launches == 1
    grads = torch.autograd.grad(out, leaves, nchw(g))
    assert twins_as_kernels[2].launches == 1
    for fn in (xla, pallas):
        ref, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=RTOL, atol=ATOL)
        for name, got, want in zip(("x", "scale", "bias", "film_scale", "film_shift"), grads,
                                   vjp(jnp.asarray(g))):
            want = np.asarray(want)
            got = got.permute(0, 2, 3, 1).numpy() if got.ndim == 4 else got.numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       atol=ATOL if name == "x" else SUM_ATOL, err_msg=name)


BWD_TOL = 2e-4


@pytest.mark.parametrize("C,hw,film,act,eps,dtype,film_dtype,pallas", [
    (128, (8, 8), False, None, 1e-5, "float32", "float32", True),
    (128, (8, 8), False, "silu", 1e-5, "float32", "float32", True),
    (128, (8, 8), True, None, 1e-5, "float32", "float32", True),
    (128, (8, 8), True, "silu", 1e-5, "float32", "float32", True),
    (128, (8, 8), True, "silu", 1e-6, "float32", "float32", True),
    # ragged: 3 channels a group at 7 x 5 (the Pallas kernel takes C % 128 == 0 only)
    (96, (7, 5), True, "silu", 1e-5, "float32", "float32", False),
    # bf16 activations with FiLM of their dtype and of fp32
    (128, (8, 8), True, "silu", 1e-5, "bfloat16", "bfloat16", False),
    (128, (8, 8), True, "silu", 1e-5, "bfloat16", "float32", False),
])
def test_group_norm_backward_plain_matches_jax_vjp(C, hw, film, act, eps, dtype, film_dtype,
                                                   pallas):
    """The closed form (``group_norm_backward_plain``, the kernel's arithmetic)
    against ``jax.vjp`` of ``_group_norm_xla`` and of ``group_norm_pallas``:
    2e-4 in fp32; in bf16 both sides compute in fp32 from the same inputs and
    round the outputs, so dx and 16-bit FiLM gradients may differ by an ulp."""
    from bbdm_tpu.ops.group_norm import _group_norm_xla
    from bbdm_tpu.ops.group_norm_pallas import group_norm_pallas

    rs = np.random.RandomState(3)
    N = 2
    jdt, fdt = jnp.dtype(dtype), jnp.dtype(film_dtype)
    x = jnp.asarray(rs.randn(N, *hw, C) * 2 + 0.5, jdt)
    scale = jnp.asarray(1 + 0.1 * rs.randn(C), jnp.float32)
    bias = jnp.asarray(0.1 * rs.randn(C), jnp.float32)
    fs, fb = (jnp.asarray(0.1 * rs.randn(N, C), fdt) for _ in range(2))
    g = jnp.asarray(rs.randn(N, *hw, C), jdt)
    args = [x, scale, bias] + ([fs, fb] if film else [])
    fns = [lambda x, s, b, *f: _group_norm_xla(x, s, b, num_groups=32, eps=eps, act=act,
                                               film_scale=f[0] if f else None,
                                               film_shift=f[1] if f else None)]
    if pallas:
        fns.append(lambda x, s, b, *f: group_norm_pallas(x, s, b, f[0] if f else None,
                                                         f[1] if f else None, 32, eps, act))
    t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch,
                                                                              str(a.dtype)))
    tx, tg = (t(a).permute(0, 3, 1, 2).contiguous() for a in (x, g))
    got = group_norm.group_norm_backward_plain(
        tx, t(scale), t(bias), tg, num_groups=32, eps=eps, act=act,
        film_scale=t(fs) if film else None, film_shift=t(fb) if film else None)
    assert got[0].dtype == tx.dtype and got[1].dtype == got[2].dtype == torch.float32
    assert (got[3] is None) == (not film) and (not film or got[3].dtype == t(fs).dtype)
    for fn in fns:
        _, vjp = jax.vjp(fn, *args)
        for name, a, want in zip(("x", "scale", "bias", "film_scale", "film_shift"), got,
                                 vjp(g)):
            tol = BWD_TOL if want.dtype == jnp.float32 else 2 ** -7  # the gradient's dtype
            want = np.asarray(want.astype(jnp.float32))
            a = (a.permute(0, 2, 3, 1) if a.ndim == 4 else a).float().numpy()
            np.testing.assert_allclose(a, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()),
                                       err_msg=name)


def test_group_norm_backward_plain_returns_only_what_is_asked():
    rs = np.random.RandomState(4)
    x, g = (torch.from_numpy(rs.randn(2, 64, 4, 4).astype(np.float32)) for _ in range(2))
    w, b = torch.ones(64), torch.zeros(64)
    fs, fb = (torch.from_numpy(0.1 * rs.randn(2, 64).astype(np.float32)) for _ in range(2))
    full = group_norm.group_norm_backward_plain(x, w, b, g, act="silu", film_scale=fs,
                                                film_shift=fb)
    for needs in [(True, False, False, False, False), (False, True, False, True, False)]:
        part = group_norm.group_norm_backward_plain(x, w, b, g, act="silu", film_scale=fs,
                                                    film_shift=fb, needs=needs)
        for need, a, f in zip(needs, part, full):
            assert (a is None) != need
            if need:
                assert torch.equal(a, f)


def test_flash_attention_function_backward_matches_jax_vjp(twins_as_kernels):
    from bbdm_tpu.ops.attention import _xla_attention
    from bbdm_tpu.ops.flash_attention import flash_attention

    rs = np.random.RandomState(1)
    q, k, v, g = (rs.randn(1, 2, 512, 128).astype(np.float32) for _ in range(4))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention.FlashAttentionFunction.apply(*leaves)
    assert twins_as_kernels[1].launches == 1
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for fn in (_xla_attention, flash_attention):
        ref, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
        for got, want in zip(grads, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=SUM_ATOL)


@pytest.mark.parametrize("op", ["group_norm", "attention"])
@pytest.mark.parametrize("grad", [True, False])
def test_dispatch_takes_the_function_exactly_where_a_gradient_is_needed(twins_as_kernels, op,
                                                                        grad):
    """With grad mode on and an input requiring grad the kernel launches inside
    the Function (its node is the output's grad_fn); under no_grad it launches
    directly, leaving nothing to save for backward."""
    rs = np.random.RandomState(2)
    if op == "group_norm":
        x = torch.from_numpy(rs.randn(2, 64, 4, 4).astype(np.float32)).requires_grad_()
        w, b = torch.ones(64), torch.zeros(64)
        call = lambda: group_norm.group_norm(x, w, b, act="silu")
        kernel, name = twins_as_kernels[0], "GroupNormFunctionBackward"
    else:
        x = torch.from_numpy(rs.randn(1, 1, 1024, 128).astype(np.float32)).requires_grad_()
        call = lambda: attention.multi_head_attention(x, x, x)
        kernel, name = twins_as_kernels[1], "FlashAttentionFunctionBackward"
    with torch.set_grad_enabled(grad):
        out = call()
    assert kernel.launches == 1
    assert (type(out.grad_fn).__name__ == name) if grad else out.grad_fn is None


@pytest.mark.parametrize("which", ["x", "kp", "b"])
def test_upsample_conv_cuda_refuses_inputs_that_require_grad(which):
    """K2 has no backward: a grad-requiring input raises before anything else
    is checked, so it can never cut a graph (and says what to train with)."""
    x, kp, b = torch.zeros(1, 8, 4, 4), torch.zeros(4, 2, 2, 8, 8), torch.zeros(8)
    dict(x=x, kp=kp, b=b)[which].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        upsample_conv.upsample_conv_cuda(x, kp, b)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        upsample_conv.upsample_conv_cuda(x, kp, b)  # no grad: on to the usual checks


def test_upsample_conv_training_form_matches_jax_train_true():
    """In training mode UpsampleConv3x3 is the naive upsample + conv + bias of
    ``bbdm_tpu/models/layers.py:139-148`` (``train=True``), with gradients;
    in eval mode the subpixel form, the same function."""
    from bbdm_tpu.models.layers import UpsampleConv3x3 as JaxUp

    rs = np.random.RandomState(3)
    x = rs.randn(2, 6, 5, 16).astype(np.float32)
    kernel = (0.1 * rs.randn(3, 3, 16, 8)).astype(np.float32)
    bias = rs.randn(8).astype(np.float32)
    g = rs.randn(2, 12, 10, 8).astype(np.float32)
    params = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    fn = lambda p, x: JaxUp(8).apply(p, x, True)
    ref, vjp = jax.vjp(fn, params, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))

    m = tl.UpsampleConv3x3(16, 8)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        m.bias.copy_(torch.from_numpy(bias))
    xt = nchw(x).requires_grad_()
    out = m.train()(xt)
    out.backward(nchw(g))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.weight.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(dp["params"]["kernel"]), rtol=RTOL, atol=SUM_ATOL)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(dp["params"]["bias"]),
                               rtol=RTOL, atol=SUM_ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(m.eval()(xt)), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_dropout_changes_the_training_forward_and_not_the_eval_forward(mode):
    """ResBlock dropout (``bbdm_tpu/models/layers.py:241-242``) after the out
    norm's SiLU: in training mode two forwards differ and both differ from the
    dropout-free block; in eval mode the block equals the dropout-free one."""
    torch.manual_seed(0)
    blocks = [tl.ResBlock(32, 32, 64, use_scale_shift_norm=True, dropout=p) for p in (0.5, 0.0)]
    tl.init_parameters(blocks[0], torch.Generator().manual_seed(1))
    blocks[1].load_state_dict(blocks[0].state_dict())
    x, emb = torch.randn(2, 32, 8, 8), torch.randn(2, 64)
    with torch.no_grad():
        ref = blocks[1].eval()(x, emb)
        getattr(blocks[0], mode)()
        a, b = blocks[0](x, emb), blocks[0](x, emb)
    if mode == "train":
        assert not torch.equal(a, b) and not torch.equal(a, ref)
    else:
        assert torch.equal(a, ref) and torch.equal(b, ref)
