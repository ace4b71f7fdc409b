"""The host-side plans of the port's CUDA kernels, checked on the CPU.

K2 (``csrc/subpixel_upconv.cu``) and K3 (``csrc/flash_attention.cu``) load their
tiles with TMA, whose tensor maps the H100 takes only within limits: box dims at
most 256 and inside the tensor, an inner box row that is a multiple of 16 bytes
and within the swizzle span, global strides that are multiples of 16 bytes. A
plan that breaks one is refused at encode time or faults at run time, so the
plans are held to them here, at every shape the LBBDM-f4 path and the
``gpu``-marked tests give the kernels. K2's C entry encodes and launches the
plan's values as they are, so the plan tested here is the one launched. K3's shared-memory layout must fit the
232,448 bytes a block may have.
"""

import os
import re
from collections import Counter

import pytest

from bbdm_tpu_torch.ops.attention import flash_padded_dim, flash_smem_bytes
from bbdm_tpu_torch.ops.upsample_conv import BK, BM, BN, plan_upconv

H100_BLOCK_SMEM = 232_448

# (N, ci, co, h, w): UNet up_2_us / up_1_us, VQGAN decoder up_2 / up_1 upsample at
# batch 8; the gpu-marked test shapes; one that needs every padding
UPCONV_SHAPES = [
    (8, 1024, 1024, 16, 16), (8, 512, 512, 32, 32), (8, 512, 512, 64, 64),
    (8, 256, 256, 128, 128), (1, 32, 96, 24, 40), (2, 64, 64, 16, 16), (1, 20, 30, 5, 7),
]


def _block_pixels(plan, bx):
    """(n, i, j) of every padded source pixel that K2's block column ``bx`` writes
    (``subpixel_upconv_kernel``'s seg = bx % segs, row tile = bx / segs % row_tiles,
    n = the rest, with segs and row_tiles from the plan)."""
    w, h = plan.x_dims[1], plan.x_dims[2]
    seg, rt = bx % plan.segs, (bx // plan.segs) % plan.row_tiles
    n = bx // (plan.segs * plan.row_tiles)
    return [(n, i, j) for i in range(rt * plan.rows, (rt + 1) * plan.rows) if i < h
            for j in range(seg * plan.w_box, (seg + 1) * plan.w_box) if j < w]


def _maps(plan):
    return [(plan.x_dims, plan.x_strides, plan.x_box), (plan.k_dims, plan.k_strides, plan.k_box)]


@pytest.mark.parametrize("shape", UPCONV_SHAPES)
def test_upconv_boxes_fit_their_tensors(shape):
    plan = plan_upconv(*shape)
    for dims, _, box in _maps(plan):
        assert len(box) == len(dims)
        assert all(1 <= b <= 256 for b in box), box
        assert all(b <= d for b, d in zip(box, dims)), (box, dims)
    # one stage holds BN pixels x BK channels of x and BM channels x BK of kp
    assert plan.rows * plan.w_box == BN
    assert plan.x_box == (BK, plan.w_box, plan.rows, 1)
    assert plan.k_box == (BK, BM, 1)


@pytest.mark.parametrize("shape", UPCONV_SHAPES)
def test_upconv_inner_box_rows_fit_the_swizzle(shape):
    plan = plan_upconv(*shape)
    for _, _, box in _maps(plan):
        inner = box[0] * 2  # bf16 bytes
        assert inner % 16 == 0 and inner <= plan.swizzle


@pytest.mark.parametrize("shape", UPCONV_SHAPES)
def test_upconv_global_strides_are_16_byte_multiples(shape):
    plan = plan_upconv(*shape)
    for dims, strides, _ in _maps(plan):
        assert len(strides) == len(dims) - 1
        assert all(s % 16 == 0 for s in strides), strides
        # dense, innermost first: each stride spans the dims inside it
        row = dims[0] * 2
        for d, s in zip(dims[1:], strides):
            assert s == row
            row *= d


@pytest.mark.parametrize("shape", UPCONV_SHAPES)
def test_upconv_tiles_cover_each_output_pixel_once(shape):
    N, ci, co, h, w = shape
    plan = plan_upconv(*shape)
    cip, wp, hp, n = plan.x_dims
    assert n == N and cip >= max(ci, BK) and cip % 8 == 0
    assert wp >= w and hp >= h and plan.k_dims[1] >= max(co, BM)
    # grid z is py; each block computes both px of its pixels, so every source
    # pixel, hence every output pixel of every phase, must belong to one block
    assert plan.grid == (N * plan.row_tiles * plan.segs, -(-plan.k_dims[1] // BM), 2)
    seen = Counter(p for bx in range(plan.grid[0]) for p in _block_pixels(plan, bx))
    assert set(seen.values()) == {1}
    assert set(seen) == {(b, i, j) for b in range(N) for i in range(hp) for j in range(wp)}


def test_upconv_c_values_match_the_c_entry_layout():
    # subpixel_upconv_bf16 reads the flat plan at fixed offsets; they must fall
    # where c_values puts each field
    src = os.path.join(os.path.dirname(__file__), os.pardir, "bbdm_tpu_torch", "csrc",
                       "subpixel_upconv.cu")
    with open(src) as f:
        text = f.read()
    offsets = {name: int(off or 0) for name, off in
               re.findall(r"\*(\w+) = plan(?: \+ (\d+))?[,;]", text)}
    offsets.update({name: int(off) for name, off in
                    re.findall(r"(\w+) = \(int\)plan\[(\d+)\]", text)})
    plan = plan_upconv(*UPCONV_SHAPES[0])
    fields = [("xd", plan.x_dims), ("xs", plan.x_strides), ("xb", plan.x_box),
              ("kd", plan.k_dims), ("ks", plan.k_strides), ("kb", plan.k_box),
              ("grid", plan.grid), ("row_tiles", (plan.row_tiles,)), ("segs", (plan.segs,))]
    at = 0
    for name, value in fields:
        assert offsets[name] == at, (name, offsets)
        assert plan.c_values()[at:at + len(value)] == tuple(value)
        at += len(value)
    assert at == len(plan.c_values()) == 24


@pytest.mark.parametrize("D", [128, 256, 512])
def test_flash_attention_smem_fits_a_block(D):
    assert flash_padded_dim(D) == D
    # Q of 64 rows x D bf16, two stages each of K and V tiles of 32 keys x D, the
    # fp32 [64 x 32] score exchange of both warpgroups, 9 mbarriers, 1 KB of
    # alignment slack
    assert flash_smem_bytes(D) == 64 * D * 2 + 4 * 32 * D * 2 + 2 * 64 * 32 * 4 + 9 * 8 + 1024
    assert flash_smem_bytes(D) <= H100_BLOCK_SMEM


@pytest.mark.parametrize("D", [16, 48, 64, 80, 200, 496])
def test_flash_attention_pads_head_dims_to_a_compiled_one(D):
    DP = flash_padded_dim(D)
    # each of the two consumer warpgroups owns DP/2 columns: whole 64-column boxes
    assert DP >= D and DP in (128, 256, 512) and (DP // 2) % 64 == 0
    assert flash_smem_bytes(D) == flash_smem_bytes(DP) <= H100_BLOCK_SMEM
