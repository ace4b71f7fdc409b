// K2: fused nearest-2x upsample + 3x3 conv (exact subpixel decomposition), bf16.
//
// Replaces bbdm_tpu/ops/subpixel_pallas.py:subpixel_upconv_pallas (the Pallas
// _kernel: 4 phases x 2x2 taps on the MXU, fp32 accumulation, the interleaved
// [2h, 2w, co] output written directly).
//
//   out[n, o, 2i+py, 2j+px] = b[o] + sum_{r,s,c} kp[p, r, s, o, c] * x[n, i+py-1+r, j+px-1+s, c]
//
// with p = 2*py + px, kp the fp32-combined phase kernel
// (ops/upsample_conv.combine_kernel_2x2, cast to bf16) and zero padding. The input
// is channels-last (the wrapper makes that copy of the NCHW activation); the
// output is NCHW.
//
// What bounds it on the H100: tensor-core FLOPs. At the path shapes it does
// 2*N*h*w*16*ci*co flops (275 GFLOP for the VQGAN decoder's 256->256 at
// 128^2 -> 256^2, batch 8) against ~(N*h*w*ci + 4*N*h*w*co)*2 bytes (~0.35 GB):
// ~800 flops/byte, above the ~295 where bf16 tensor cores bind.
//
// Design: an implicit GEMM per phase with M = co, N = source pixels, K = 4 taps x ci.
// A block owns 128 output channels x 128 source pixels (R image rows of a
// WBOX-wide segment, WBOX * R = 128, of one sample) for one py and both px, so its
// epilogue writes whole output row segments of 2*WBOX elements.
// - Warp specialisation: one producer thread (warpgroup 2, registers lowered with
//   setmaxnreg) streams a 4-stage ring of [A | B] tiles with TMA, tracked by full
//   and empty mbarriers; two consumer warpgroups (registers raised) each run
//   wgmma m64n128k16 on their 64 channels, fp32 accumulators in registers, one
//   wgmma group kept in flight.
// - A = kp[p, r, s, o0:o0+128, c0:c0+64]: a 3-D TMA box, K-major, 128-byte swizzle.
// - B = x[n, i0+py-1+r : +R, j0+px-1+s : +WBOX, c0:c0+64]: one 4-D TMA box over
//   (ci, w, h, n), K-major, 128-byte swizzle. The tap shift is the box's start
//   coordinate, and TMA's zero fill outside the tensor is exactly the conv's
//   padding, so the shift and the border cost no instructions. (On NCHW the shift
//   would fall on the innermost, contiguous axis, where TMA takes only 16-byte
//   aligned starts: hence the channels-last input.)
// - Epilogue: fp32 bias, one bf16 rounding; the px=0 results wait in registers as
//   bf16 pairs while px=1 accumulates, the interleaved pairs go to a padded
//   shared-memory tile, and the block writes it out as 16-byte stores.
// What holds it back now: no persistent schedule, so each block's epilogue and
// pipeline fill do not overlap another tile's main loop; each tap re-loads its
// shifted input box (from L2); the channels-last copy is one extra pass over x.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;      // output channels per block (2 consumer warpgroups x 64)
constexpr int BN = 128;      // source pixels per block
constexpr int BK = 64;       // input channels per stage (one 128-byte swizzle span)
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; warpgroup 2: producer
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_LD = 2 * BN + 16;  // bf16 elements per staged output row, padded
constexpr int OUT_OFF = STAGES * STAGE_BYTES;
constexpr int BAR_OFF = OUT_OFF + BM * OUT_LD * 2;
constexpr int SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack

template <int WBOX>
__global__ void __launch_bounds__(THREADS, 1)
subpixel_upconv_kernel(__grid_constant__ const CUtensorMap map_x,  // x [N, h, w, ci]
                       __grid_constant__ const CUtensorMap map_k,  // kp [16, co, ci]
                       const float* __restrict__ bias,             // [co]
                       __nv_bfloat16* __restrict__ out,            // [N, co, 2h, 2w]
                       int ci, int co, int h, int w, int row_tiles, int segs) {
  constexpr int R = BN / WBOX;  // image rows per tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* out_s = reinterpret_cast<__nv_bfloat16*>(smem + OUT_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int seg = blockIdx.x % segs;
  const int rt = (blockIdx.x / segs) % row_tiles;
  const int n = blockIdx.x / (segs * row_tiles);
  const int i0 = rt * R, j0 = seg * WBOX;
  const int o0 = blockIdx.y * BM;
  const int py = blockIdx.z;
  const int kc_n = (ci + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (tid == 256) {
      prefetch_tensormap(&map_x);
      prefetch_tensormap(&map_k);
      int stage = 0;
      uint32_t phase = 0;
      for (int px = 0; px < 2; ++px)
        for (int tap = 0; tap < 4; ++tap)
          for (int kc = 0; kc < kc_n; ++kc) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
            unsigned char* a = smem + stage * STAGE_BYTES;
            const int r = tap >> 1, s = tap & 1;
            tma_load_3d(a, &map_k, &full[stage], kc * BK, o0, (2 * py + px) * 4 + tap);
            tma_load_4d(a + A_BYTES, &map_x, &full[stage], kc * BK, j0 + px - 1 + s,
                        i0 + py - 1 + r, n);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int g = tid >> 7;  // warpgroup: output channels o0 + 64g ...
    const int lt = tid & 127;
    const int lane = lt & 31;
    // accumulator layout of m64nNk16: d[4j + 2h + e] is row 16*warp + lane/4 + 8h,
    // column 8j + 2*(lane%4) + e
    const int row_base = g * 64 + (lt >> 5) * 16 + (lane >> 2);
    float bo[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int o = o0 + row_base + 8 * hh;
      bo[hh] = o < co ? bias[o] : 0.0f;
    }

    float acc[64];
    uint32_t keep[32];  // the px=0 results as bf16 pairs
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    const int ksteps = 4 * kc_n;
#pragma unroll 1
    for (int px = 0; px < 2; ++px) {
#pragma unroll 1
      for (int it = 0; it < ksteps; ++it) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_base = smem_u32(smem + stage * STAGE_BYTES) + g * 64 * BK * 2;
        const uint32_t b_base = smem_u32(smem + stage * STAGE_BYTES + A_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_ss_n128<0>(acc, make_desc(a_base + k * 32, 16, 1024),
                           make_desc(b_base + k * 32, 16, 1024), (it > 0 || k > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (it > 0 && lt == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lt == 0) mbar_arrive(&empty[prev]);

      if (px == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            keep[2 * j + hh] = pack_bf16x2(acc[4 * j + 2 * hh] + bo[hh],
                                           acc[4 * j + 2 * hh + 1] + bo[hh]);
      } else {
        // source pixels q, q+1 of a tile row -> output columns 2q (px 0), 2q+1 (px 1),
        // 2q+2, 2q+3
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int q = 8 * j + 2 * (lane & 3);
          const int t = q / WBOX, jj = q % WBOX;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t p1 = pack_bf16x2(acc[4 * j + 2 * hh] + bo[hh],
                                            acc[4 * j + 2 * hh + 1] + bo[hh]);
            const uint32_t p0 = keep[2 * j + hh];
            uint2 v;
            v.x = (p0 & 0xFFFFu) | (p1 << 16);
            v.y = (p0 >> 16) | (p1 & 0xFFFF0000u);
            *reinterpret_cast<uint2*>(out_s + (row_base + 8 * hh) * OUT_LD + t * 2 * WBOX +
                                      2 * jj) = v;
          }
        }
      }
    }
    named_barrier(1, 256);

    // whole output row segments: row 2i+py, columns 2*j0 ... 2*(j0 + valid) - 1
    const int valid = min(WBOX, w - j0);
    const long long w2 = 2LL * w, h2 = 2LL * h;
    if ((w & 3) == 0) {  // 16-byte aligned rows: 8-element vectors
      constexpr int VPL = WBOX / 4;
      for (int v = tid; v < BM * R * VPL; v += 256) {
        const int ol = v / (R * VPL), t = (v / VPL) % R, c = v % VPL;
        const int o = o0 + ol, i = i0 + t;
        if (o < co && i < h && c < valid / 4)
          *reinterpret_cast<uint4*>(out + (((long long)n * co + o) * h2 + 2 * i + py) * w2 +
                                    2 * j0 + 8 * c) =
              *reinterpret_cast<const uint4*>(out_s + ol * OUT_LD + t * 2 * WBOX + 8 * c);
      }
    } else {
      for (int v = tid; v < BM * R * 2 * WBOX; v += 256) {
        const int ol = v / (R * 2 * WBOX), t = (v / (2 * WBOX)) % R, c = v % (2 * WBOX);
        const int o = o0 + ol, i = i0 + t;
        if (o < co && i < h && c < 2 * valid)
          out[(((long long)n * co + o) * h2 + 2 * i + py) * w2 + 2 * j0 + c] =
              out_s[ol * OUT_LD + t * 2 * WBOX + c];
      }
    }
  }
}

template <int WBOX>
int launch(const CUtensorMap& mx, const CUtensorMap& mk, const float* bias, __nv_bfloat16* out,
           int ci, int co, int h, int w, int row_tiles, int segs, dim3 grid,
           cudaStream_t stream) {
  static std::atomic<uint64_t> smem_ready{0};
  const int rc = allow_dynamic_smem(subpixel_upconv_kernel<WBOX>, SMEM_BYTES, smem_ready);
  if (rc != 0) return rc;
  subpixel_upconv_kernel<WBOX><<<grid, THREADS, SMEM_BYTES, stream>>>(mx, mk, bias, out, ci, co,
                                                                      h, w, row_tiles, segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [N, h, w, ci] bf16 (channels-last), kp [4, 2, 2, co, ci] bf16, bias [co] fp32,
// out [N, co, 2h, 2w] bf16. `plan` holds the 24 values of
// ops/upsample_conv.UpconvPlan.c_values, which this entry encodes and launches as
// they are: x's tensor map (dims ci, w, h, N; byte strides of dims 1..3; box),
// kp's (dims ci, co, 16; strides; box), the grid, row_tiles and segs. The boxes
// must be the ones the kernel is compiled for: x (64, w_box, 128 / w_box, 1) with
// w_box a power of two from 8 to 128, kp (64, 128, 1). Returns a cudaError_t.
extern "C" int subpixel_upconv_bf16(const void* x, const void* kp, const void* bias, void* out,
                                    const uint64_t* plan, void* stream) {
  const uint64_t *xd = plan, *xs = plan + 4, *xb = plan + 7, *kd = plan + 11, *ks = plan + 14,
                 *kb = plan + 16, *grid = plan + 19;
  const int row_tiles = (int)plan[22], segs = (int)plan[23];
  const int w_box = (int)xb[1];
  if (xb[0] != BK || w_box < 8 || w_box > 128 || (w_box & (w_box - 1)) != 0 ||
      xb[2] * w_box != BN || xb[3] != 1 || kb[0] != BK || kb[1] != BM || kb[2] != 1 ||
      kd[0] != xd[0] || grid[0] != xd[3] * row_tiles * segs || grid[2] != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mk;
  int rc = encode_bf16_map(&mx, x, 4, xd, xs, xb);
  if (rc != 0) return rc;
  rc = encode_bf16_map(&mk, kp, 3, kd, ks, kb);
  if (rc != 0) return rc;
  const float* b = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const int ci = (int)xd[0], w = (int)xd[1], h = (int)xd[2], co = (int)kd[1];
  const dim3 g((unsigned)grid[0], (unsigned)grid[1], (unsigned)grid[2]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w_box) {
    case 8: return launch<8>(mx, mk, b, o, ci, co, h, w, row_tiles, segs, g, st);
    case 16: return launch<16>(mx, mk, b, o, ci, co, h, w, row_tiles, segs, g, st);
    case 32: return launch<32>(mx, mk, b, o, ci, co, h, w, row_tiles, segs, g, st);
    case 64: return launch<64>(mx, mk, b, o, ci, co, h, w, row_tiles, segs, g, st);
    default: return launch<128>(mx, mk, b, o, ci, co, h, w, row_tiles, segs, g, st);
  }
}
