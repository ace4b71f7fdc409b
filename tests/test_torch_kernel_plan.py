"""The host-side plans of the port's CUDA kernels, checked on the CPU.

K1 (``csrc/group_norm.cu``) launches one cluster of CTAs per (n, group) span
with the slices, bulk copies and shared memory that ``plan_group_norm`` decides;
its C entry launches the plan's values as they are. The plan is held here to the
card's limits (shared memory, cluster size), to tiling each span exactly once,
and to 16-byte aligned bulk copies, at every GroupNorm shape of the LBBDM-f4
path and of the ``gpu``-marked tests.

K2 (``csrc/subpixel_upconv.cu``) and K3 (``csrc/flash_attention.cu``) load their
tiles with TMA, whose tensor maps the H100 takes only within limits: box dims at
most 256 and inside the tensor, an inner box row that is a multiple of 16 bytes
and within the swizzle span, global strides that are multiples of 16 bytes. A
plan that breaks one is refused at encode time or faults at run time, so the
plans are held to them here, at every shape the LBBDM-f4 path and the
``gpu``-marked tests give the kernels. K2's C entry encodes and launches the
plan's values as they are, so the plan tested here is the one launched. K3's shared-memory layout must fit the
232,448 bytes a block may have. The fp32 entries (``csrc/*_f32.cu``) load fp32
boxes of 32 values (one 128-byte swizzle row) under the same limits.
"""

import os
import re
from collections import Counter

import pytest
import torch

from bbdm_tpu_torch.ops import group_norm as gn
from bbdm_tpu_torch.ops.attention import flash_f32_smem_bytes, flash_padded_dim, flash_smem_bytes
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


def _c_offsets(name):
    src = os.path.join(os.path.dirname(__file__), os.pardir, "bbdm_tpu_torch", "csrc", name)
    with open(src) as f:
        text = f.read()
    offsets = {n: int(off or 0) for n, off in re.findall(r"\*(\w+) = plan(?: \+ (\d+))?[,;]", text)}
    offsets.update({n: int(off) for n, off in re.findall(r"(\w+) = \(int\)plan\[(\d+)\]", text)})
    return offsets


@pytest.mark.parametrize("shape", UPCONV_SHAPES)
def test_upconv_f32_plan_fits_tma_and_covers_each_pixel_once(shape):
    """fp32 K2: boxes of 32 channels (128 bytes, the swizzle span) inside their
    tensors, dense 16-byte multiple strides, ci padded to a multiple of 4 and at
    least 32, and the bf16 plan's tiling of pixels and channels."""
    N, ci, co, h, w = shape
    plan = plan_upconv(*shape, esize=4)
    bf16 = plan_upconv(*shape)
    for dims, strides, box in _maps(plan):
        assert all(1 <= b <= 256 for b in box) and all(b <= d for b, d in zip(box, dims))
        assert box[0] * 4 == plan.swizzle
        row = dims[0] * 4
        for d, st in zip(dims[1:], strides):
            assert st == row and st % 16 == 0
            row *= d
    cip = plan.x_dims[0]
    assert cip == max(32, -(-ci // 4) * 4)
    assert plan.x_box == (32, bf16.w_box, bf16.rows, 1) and plan.k_box == (32, BM, 1)
    assert (plan.grid, plan.row_tiles, plan.segs, plan.x_dims[1:]) == (
        bf16.grid, bf16.row_tiles, bf16.segs, bf16.x_dims[1:])


def test_upconv_f32_c_values_match_the_c_entry_layout():
    offsets = _c_offsets("subpixel_upconv_f32.cu")
    plan = plan_upconv(*UPCONV_SHAPES[3], esize=4)
    fields = [("xd", plan.x_dims), ("xs", plan.x_strides), ("xb", plan.x_box),
              ("kd", plan.k_dims), ("ks", plan.k_strides), ("kb", plan.k_box),
              ("grid", plan.grid), ("row_tiles", (plan.row_tiles,)), ("segs", (plan.segs,))]
    at = 0
    for name, value in fields:
        assert offsets[name] == at, (name, offsets)
        assert plan.c_values()[at:at + len(value)] == tuple(value)
        at += len(value)
    assert at == len(plan.c_values()) == 24


@pytest.mark.parametrize("D", [16, 48, 128, 200, 256, 512])
def test_flash_attention_f32_smem_fits_a_block(D):
    """fp32 K3: Q of 64 rows x DP fp32, a 3-slot ring of 16-key tiles x DP fp32, 7
    mbarriers, 1 KB of alignment slack; the score exchange borrows a K slot, which
    must hold 8 warps x 32 rows x 16 keys of fp32."""
    DP = flash_padded_dim(D)
    slot = max(16 * DP * 4, 8 * 32 * 16 * 4)
    assert flash_f32_smem_bytes(D) == 64 * DP * 4 + 3 * slot + 7 * 8 + 1024
    assert flash_f32_smem_bytes(D) <= H100_BLOCK_SMEM


@pytest.mark.parametrize("D", [64, 128, 256, 512])
def test_flash_attention_smem_fits_a_block(D):
    assert flash_padded_dim(D, torch.bfloat16) == D
    if D <= 128:
        # the row split: Q of 128 rows x D bf16, four stages each of K and V
        # tiles of 32 keys x D, 17 mbarriers, 1 KB of alignment slack
        want = 128 * D * 2 + 8 * 32 * D * 2 + 17 * 8 + 1024
    else:
        # the depth split: Q of 64 rows x D bf16, two stages each of K and V
        # tiles, the fp32 [64 x 32] score exchange of both warpgroups, 9
        # mbarriers, 1 KB of alignment slack
        want = 64 * D * 2 + 4 * 32 * D * 2 + 2 * 64 * 32 * 4 + 9 * 8 + 1024
    assert flash_smem_bytes(D) == want
    assert flash_smem_bytes(D) <= H100_BLOCK_SMEM


@pytest.mark.parametrize("D", [16, 40, 48, 64, 80, 160, 200, 496])
def test_flash_attention_pads_head_dims_to_a_compiled_one(D):
    DP = flash_padded_dim(D, torch.bfloat16)
    # a consumer warpgroup owns all DP columns (row split, DP <= 128) or DP/2
    # (depth split): whole 64-column boxes either way
    assert DP >= D and DP in (64, 128, 256, 512)
    assert (DP if DP <= 128 else DP // 2) % 64 == 0
    assert flash_smem_bytes(D) == flash_smem_bytes(DP) <= H100_BLOCK_SMEM


# ------------------------------------------------------------- GroupNorm (K1)

# (N, C, H, W) of every GroupNorm on the LBBDM-f4 path at batch 8 (UNet 44 calls
# per sampler step, VQGAN encoder 18, decoder 24; bf16), as
# test_group_norm_path_shapes_are_the_models finds them in the port's modules
GN_PATH_SHAPES = [
    (8, 128, 64, 64), (8, 128, 32, 32), (8, 512, 32, 32), (8, 512, 16, 16),
    (8, 1024, 16, 16), (8, 2048, 16, 16), (8, 1536, 16, 16), (8, 1536, 32, 32),
    (8, 1024, 32, 32), (8, 640, 32, 32), (8, 640, 64, 64), (8, 256, 64, 64),
    (8, 512, 64, 64), (8, 128, 256, 256), (8, 256, 128, 128), (8, 128, 128, 128),
    (8, 512, 128, 128), (8, 256, 256, 256),
]
# (N, C, H, W, itemsize) of the gpu-marked tests and chip_smoke.py's extra cases:
# small bf16 and film shapes, fp32, a span that overflows a cluster of 8 (fp32 at
# 256^2), a ragged span (C = 96 at 7 x 5), fp16, a cluster of 4, and a ragged span
# split over a cluster of 2
GN_EDGE_SHAPES = [
    (2, 640, 16, 16, 2), (2, 256, 32, 32, 2), (1, 128, 64, 64, 4), (1, 256, 256, 256, 4),
    (2, 96, 7, 5, 2), (2, 320, 24, 24, 2), (2, 256, 128, 128, 2), (2, 32, 255, 255, 2),
]
GN_SHAPES = [(*s, 2) for s in GN_PATH_SHAPES] + GN_EDGE_SHAPES


def _gn_plan(shape):
    N, C, H, W, itemsize = shape
    return gn.plan_group_norm(N, C, H * W, 32, itemsize)


def _gn_slices(plan):
    """(start, len, keep) of each CTA rank's slice of a span, as
    ``group_norm_kernel`` computes them from the plan."""
    out = []
    for rank in range(plan.cs):
        start = rank * plan.per
        length = max(0, min(plan.per, plan.span - start))
        out.append((start, length, min(length, plan.keep)))
    return out


def test_group_norm_path_shapes_are_the_models():
    """Walk the full-width UNet and VQGAN on the meta device (no memory, no
    arithmetic) with a recorder in place of the GroupNorm op."""
    import torch

    from bbdm_tpu_torch.config import lbbdm_f4_config
    from bbdm_tpu_torch.models.unet import UNet
    from bbdm_tpu_torch.models.vqgan import VQModel
    from bbdm_tpu_torch.ops import attention, upsample_conv

    seen = []

    def record(x, *args, **kw):
        seen.append(tuple(x.shape))
        return torch.empty_like(x)

    cfg = lbbdm_f4_config().model
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(gn, "group_norm", record)
        for mod in (upsample_conv, attention):  # the twins' shape arithmetic on meta
            mp.setattr(mod, "use_kernel", lambda x: False)
        unet = UNet.from_config(cfg.BB.params.UNetParams, "nocond", device="meta")
        vq = VQModel.from_config(cfg.VQGAN.params, dtype=torch.bfloat16, device="meta")
        with torch.no_grad():
            unet(torch.empty(8, 3, 64, 64, device="meta"),
                 torch.zeros(8, dtype=torch.int32, device="meta"))
            counts = [len(seen)]
            vq.encoder(torch.empty(8, 3, 256, 256, device="meta"))
            counts.append(len(seen) - sum(counts))
            vq.decoder(torch.empty(8, 3, 64, 64, device="meta"))
            counts.append(len(seen) - sum(counts))
    finally:
        mp.undo()
    assert counts == [44, 18, 24]
    assert sorted(set(seen)) == sorted(GN_PATH_SHAPES)


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_plan_fits_the_card(shape):
    plan = _gn_plan(shape)
    N, C = shape[:2]
    assert plan.cs in gn.CLUSTER_SIZES and plan.cs <= 8
    assert plan.grid == N * 32 * plan.cs
    assert plan.threads == gn.THREADS
    assert plan.smem_bytes <= H100_BLOCK_SMEM - 1024
    # the slice (with one vector of slack for an unaligned start), then the
    # per-channel scale and shift
    assert plan.sc_off >= (plan.keep + 16 // plan.itemsize) * plan.itemsize
    assert plan.sc_off % 16 == 0 and plan.smem_bytes == plan.sc_off + 2 * 4 * plan.cpg
    assert 1 <= plan.nchunks <= gn.MAX_CHUNKS and plan.chunk * plan.nchunks >= plan.keep
    if plan.per * plan.itemsize <= gn.PAIR_BUDGET:  # two CTAs per SM
        assert 2 * (plan.smem_bytes + 1024) <= 233_472


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_slices_tile_each_span_once(shape):
    plan = _gn_plan(shape)
    assert plan.span == plan.cpg * shape[2] * shape[3]
    covered = []
    for start, length, keep in _gn_slices(plan):
        covered += range(start, start + length)
        assert 0 <= keep <= length and length - keep <= plan.overflow
    assert covered == list(range(plan.span))
    # the smallest cluster that holds the span, unless even 8 CTAs do not
    smaller = [cs for cs in gn.CLUSTER_SIZES if cs < plan.cs]
    if plan.overflow == 0 and smaller:
        prev = smaller[-1]
        assert -(-plan.span // prev) * plan.itemsize > gn.PAIR_BUDGET


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_bulk_copies_are_16_byte_aligned(shape):
    plan = _gn_plan(shape)
    N = shape[0]
    if not plan.bulk:
        assert plan.span * plan.itemsize % 16 != 0
        return
    s = plan.itemsize
    for ng in range(N * 32):
        for start, _, keep in _gn_slices(plan):
            for c0 in range(0, keep, plan.chunk):
                size = min(plan.chunk, keep - c0) * s
                assert ((ng * plan.span + start + c0) * s) % 16 == 0  # source
                assert (c0 * s) % 16 == 0  # destination in shared memory
                assert size % 16 == 0 and 0 < size < 2 ** 20  # an mbarrier's tx count


def test_group_norm_shapes_reach_every_cluster_size():
    plans = [_gn_plan(s) for s in GN_SHAPES]
    assert {p.cs for p in plans} == set(gn.CLUSTER_SIZES)
    assert any(p.overflow > 0 for p in plans) and any(not p.bulk for p in plans)
    assert any(not p.bulk and p.cs > 1 for p in plans)


def test_group_norm_c_values_match_the_c_entry_layout():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "bbdm_tpu_torch", "csrc",
                       "group_norm.cu")
    with open(src) as f:
        text = f.read()
    offsets = dict(re.findall(r"(\w+) = plan\[(\d+)\]", text))
    plan = _gn_plan(GN_SHAPES[0])
    assert {name: int(off) for name, off in offsets.items()} == \
        {name: i for i, name in enumerate(plan._fields)}
    assert plan.c_values() == tuple(getattr(plan, f) for f in plan._fields)


@pytest.mark.parametrize("dtype,film", [(torch.bfloat16, False), (torch.bfloat16, True),
                                        (torch.float32, True)])
def test_group_norm_bytes_count_each_tensor_once(dtype, film):
    N, C, H, W = 2, 64, 5, 7
    x, w = torch.empty(N, C, H, W, dtype=dtype), torch.empty(C)
    f = torch.empty(N, 2 * C, dtype=dtype)
    fs, fb = f.chunk(2, dim=1)  # the views the UNet passes: halves of one [N, 2C] tensor
    size = x.element_size()
    expect = 2 * x.numel() * size + 2 * C * 4 + (f.numel() * size if film else 0)
    assert gn.group_norm_bytes(x, w, fs if film else None) == expect


# ------------------------------------------------------ GroupNorm backward (K1)

# (N, C, H, W) of the 44 GroupNorms of one training microbatch of the LBBDM-f4
# UNet at batch 8 (``chip_smoke.kernel_calls``' ``unet_train``), the norms whose
# backward runs in bf16 training
GN_TRAIN_SHAPES = [
    (8, 128, 32, 32), (8, 128, 64, 64), (8, 256, 64, 64), (8, 512, 16, 16), (8, 512, 32, 32),
    (8, 512, 64, 64), (8, 640, 32, 32), (8, 640, 64, 64), (8, 1024, 16, 16), (8, 1024, 32, 32),
    (8, 1536, 16, 16), (8, 1536, 32, 32), (8, 2048, 16, 16),
]
# bf16 train shapes, every path shape in fp32 (VQGAN training: spans up to 1 MB,
# which overflow a cluster of 8), and the gpu-marked tests' edge shapes
GN_BWD_SHAPES = [(*s, 2) for s in GN_TRAIN_SHAPES] + [(*s, 4) for s in GN_PATH_SHAPES] + [
    (2, 128, 32, 32, 2), (2, 1024, 32, 32, 2), (2, 640, 64, 64, 2), (1, 256, 128, 128, 2),
    (2, 256, 256, 256, 2), (1, 256, 256, 256, 4), (1, 128, 64, 64, 4), (2, 96, 7, 5, 2),
    (2, 32, 255, 255, 2), (2, 320, 24, 24, 2),
]


def _gn_bwd_plan(shape):
    N, C, H, W, itemsize = shape
    return gn.plan_group_norm_bwd(N, C, H * W, 32, itemsize)


def _gn_bwd_regions(plan, rank):
    """{warp: (first, last) channel of its region} of CTA ``rank``'s slice and
    the slice's (start, len, vectors a warp), as ``group_norm_bwd_kernel``
    computes them."""
    start = rank * plan.per
    length = max(0, min(plan.per, plan.span - start))
    nvec = length // plan.vec
    rv = -(-nvec // gn.BWD_WARPS)
    out = {}
    for w in range(gn.BWD_WARPS):
        lo, hi = w * rv, min(nvec, (w + 1) * rv)
        if lo < hi:
            out[w] = ((start + lo * plan.vec) // plan.hw, (start + hi * plan.vec - 1) // plan.hw)
    return out, (start, length, rv)


@pytest.mark.parametrize("shape", GN_BWD_SHAPES)
def test_group_norm_bwd_plan_holds_x_and_dy(shape):
    plan = _gn_bwd_plan(shape)
    N, C = shape[:2]
    wide = 16 // plan.itemsize
    assert plan.cs in gn.CLUSTER_SIZES and plan.grid == N * 32 * plan.cs
    assert plan.threads == gn.THREADS and plan.cpg == C // 32
    # x's slice, then dy's, then fp32 scratch: 8 values a channel of the group, 2 a warp
    assert plan.keep % wide == 0 and plan.d_off == plan.keep * plan.itemsize
    assert plan.d_off % 16 == 0 and plan.f_off == 2 * plan.d_off
    assert plan.smem_bytes == plan.f_off + 4 * (8 * plan.cpg + 2 * gn.BWD_WARPS)
    assert plan.smem_bytes <= H100_BLOCK_SMEM - 1024
    if 2 * plan.per * plan.itemsize <= gn.PAIR_BUDGET:  # two CTAs per SM
        assert 2 * (plan.smem_bytes + 1024) <= 233_472
    # one access never spans two channels, and every slice starts on a whole vector
    assert plan.hw % plan.vec == 0 and plan.vec in (1, wide) and plan.per % wide == 0
    assert (plan.vec == wide) == (plan.hw % wide == 0)


@pytest.mark.parametrize("shape", GN_BWD_SHAPES)
def test_group_norm_bwd_slices_tile_each_span_once(shape):
    plan = _gn_bwd_plan(shape)
    covered = []
    for rank in range(plan.cs):
        start = rank * plan.per
        length = max(0, min(plan.per, plan.span - start))
        covered += range(start, start + length)
        assert length - min(length, plan.keep) <= plan.overflow
    assert covered == list(range(plan.span))
    # the smallest cluster whose slices of x and dy fit two CTAs an SM, else one
    smaller = [cs for cs in gn.CLUSTER_SIZES if cs < plan.cs]
    if plan.overflow == 0 and smaller:
        per = -(-plan.span // smaller[-1])
        assert 2 * per * plan.itemsize > gn.PAIR_BUDGET


def test_group_norm_bwd_shapes_reach_every_cluster_size_and_the_overflow():
    plans = [_gn_bwd_plan(s) for s in GN_BWD_SHAPES]
    assert {p.cs for p in plans} == set(gn.CLUSTER_SIZES)
    assert any(p.overflow > 0 and p.itemsize == 2 for p in plans)
    assert any(p.overflow > 0 and p.itemsize == 4 for p in plans)
    assert any(p.vec == 1 and p.cs > 1 for p in plans)


@pytest.mark.parametrize("shape", GN_BWD_SHAPES)
def test_group_norm_bwd_warp_entries_and_partials_do_not_collide(shape):
    """Warp w keeps channel c's sums at entry c + w: the entries the warps of a
    CTA touch are distinct and inside the scratch; the kernel sums channel c
    over exactly the warps whose region meets it. The CTA of rank c % cs writes
    the (n, c) outputs: each of the [N, C] partials once."""
    plan = _gn_bwd_plan(shape)
    N, C = shape[:2]
    for rank in range(plan.cs):
        regions, (start, length, rv) = _gn_bwd_regions(plan, rank)
        entries = [c + w for w, (lo, hi) in regions.items() for c in range(lo, hi + 1)]
        assert len(entries) == len(set(entries))
        assert all(0 <= e < plan.cpg + gn.BWD_WARPS for e in entries)
        for c in range(plan.cpg):
            lo = max(c * plan.hw, start) - start
            hi = min((c + 1) * plan.hw, start + length) - start
            summed = set(range(lo // plan.vec // rv, (hi // plan.vec - 1) // rv + 1)) \
                if lo < hi else set()
            assert summed == {w for w, (a, b) in regions.items() if a <= c <= b}
    written = Counter(n * C + g * plan.cpg + c for n in range(N) for g in range(32)
                      for rank in range(plan.cs) for c in range(rank, plan.cpg, plan.cs))
    assert sorted(written) == list(range(N * C)) and set(written.values()) == {1}


def test_group_norm_bwd_c_values_match_the_c_entry_layout():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "bbdm_tpu_torch", "csrc",
                       "group_norm_bwd.cu")
    with open(src) as f:
        text = f.read()
    offsets = dict(re.findall(r"(\w+) = plan\[(\d+)\]", text))
    plan = _gn_bwd_plan(GN_BWD_SHAPES[0])
    assert {name: int(off) for name, off in offsets.items()} == \
        {name: i for i, name in enumerate(plan._fields)}
    assert plan.c_values() == tuple(getattr(plan, f) for f in plan._fields)
