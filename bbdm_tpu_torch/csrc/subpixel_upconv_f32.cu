// K2, fp32: fused nearest-2x upsample + 3x3 conv (exact subpixel decomposition),
// on the tensor cores in 3xTF32.
//
// Replaces bbdm_tpu/ops/subpixel_pallas.py:subpixel_upconv_pallas for fp32 inputs
// (the Pallas kernel takes any dtype: 4 phases x 2x2 taps, fp32 accumulation, the
// interleaved output written directly):
//
//   out[n, o, 2i+py, 2j+px] = b[o] + sum_{r,s,c} kp[p, r, s, o, c] * x[n, c, i+py-1+r, j+px-1+s]
//
// with p = 2*py + px, kp the fp32-combined phase kernel
// (ops/upsample_conv.combine_kernel_2x2) and zero padding. x and out are NCHW.
//
// Arithmetic: 3xTF32. Each operand is split as a = hi + lo, hi = tf32_rna(a),
// lo = tf32_rna(a - hi) (ops.split_tf32 is the plain version), and each product
// is hi*hi + hi*lo + lo*hi on the TF32 tensor cores, accumulated in fp32: the
// dropped lo*lo and lo's own rounding are ~2^-22 of the product, where one TF32
// pass would keep only 2^-11 and miss the fp32 bar (1e-4 + 1e-4|ref|) by 6-14x.
//
// What bounds it on the H100: tensor-core operations. At the VQGAN decoder's
// shapes, [8, 512, 64, 64] -> 512 and [8, 256, 128, 128] -> 256, it does
// 2*N*h*w*16*ci*co = 275 GFLOP, three TF32 passes: 1.67 ms at 495 TFLOP/s
// (4.10 ms for the same work as fp32 FMAs at 67 TFLOP/s), against ~0.6 GB read
// and written.
//
// Design: the bf16 K2's pipeline (csrc/subpixel_upconv.cu) with 4-byte elements.
// - A pre-pass (subpixel_upconv_f32_kernel_split_x) writes x_hi and x_lo
//   channels-last [N, hp, wp, cip], zero-padded as ops/upsample_conv.plan_upconv
//   says, through a 32 x 32 shared-memory transpose; a second one
//   (subpixel_upconv_f32_kernel_split_k) writes kp_hi and kp_lo [16, cop, cip].
//   TF32 wgmma takes K-major operands only: kp is K-major as it is (ci
//   innermost), and the channels-last x is K-major too.
// - An implicit GEMM per phase with M = co, N = source pixels, K = 4 taps x ci:
//   a block owns 128 output channels x 128 source pixels (R image rows of a
//   WBOX-wide segment) for one py and both px.
// - One producer thread (warpgroup 2) streams a 3-stage ring with TMA: per
//   stage of BK = 32 input channels (one 128-byte swizzle row of fp32) the four
//   boxes A_hi, A_lo (kp, 128 x 32) and B_hi, B_lo (x, 128 pixels x 32), 16 KB
//   each, 64 KB a stage, 192 KB in all. The tap shift is the x box's start
//   coordinate, and TMA's zero fill is the conv's padding.
// - Two consumer warpgroups each run, per k = 8 step, three wgmma m64n128k8
//   TF32 (lo*hi, hi*lo, hi*hi) into 64 fp32 accumulators that start fresh
//   every PROMOTE = 8 stages and are then added into a second set with fp32
//   adds; one wgmma group stays in flight between those adds. The tensor
//   cores' accumulation truncates: over the 4 x ci / 8 steps of one
//   accumulator it moved outputs of order 3 by 1.3e-4 at ci = 512 on an H100,
//   past the 1e-4 + 1e-4|ref| bar; with the adds every 8 stages the path
//   shapes sit at 0.14 / 0.09 of the bar (0.49 / 0.19 without).
// - Epilogue: fp32 bias. After px = 0 the results go to a scratch half0
//   [2 (py), N, co, h, w] (registers are full: 64 accumulators and 64 sums);
//   after px = 1 each thread reads back its pair and writes (px 0, px 1) of two
//   neighbouring source pixels as one float4 of an output row. Single floats
//   at stride 2 from each px cost a partial-sector write each: 0.6 ms more at
//   [8, 256, 128, 128] on an H100.
// Budget: 3 stages x 64 KB + barriers = 197,680 bytes of shared memory; ptxas
// (CUDA 12.9) compiles the 384-thread block for 168 registers a thread
// (setmaxnreg raises the consumers only at run time), and the consumers' 64
// accumulators and 64 sums spill 192-448 bytes in the WBOX = 8 ... 64 variants
// (none at 128); the build log in _build/ has the lines.
// What holds it back: every PROMOTE stages the wgmma pipe drains; half0 goes
// out and back through device memory; the pre-pass writes and re-reads x twice over
// (hi and lo); no persistent schedule; each tap re-loads its box from L2.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;       // output channels per block (2 consumer warpgroups x 64)
constexpr int BN = 128;       // source pixels per block
constexpr int BK = 32;        // input channels per stage (one 128-byte swizzle row of fp32)
constexpr int STAGES = 3;
constexpr int PROMOTE = 8;    // stages summed by the tensor cores before an fp32 add
constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; warpgroup 2: producer
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;  // A_hi, A_lo, B_hi, B_lo
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack

// x [N, ci, h, w] -> x_hi, x_lo [N, hp, wp, cip]; one 32 x 32 (channels x columns)
// tile of one image row per block, zero outside x
__global__ void __launch_bounds__(256)
subpixel_upconv_f32_kernel_split_x(const float* __restrict__ x, float* __restrict__ x_hi,
                                   float* __restrict__ x_lo, int ci, int h, int w, int cip,
                                   int hp, int wp, int cblocks) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * 32, i = blockIdx.y;
  const int n = blockIdx.z / cblocks, c0 = (blockIdx.z % cblocks) * 32;
  const bool row = i < h;
  for (int cc = ty; cc < 32; cc += 8) {
    const int c = c0 + cc, j = j0 + tx;
    tile[cc][tx] = row && c < ci && j < w ? x[(((size_t)n * ci + c) * h + i) * w + j] : 0.0f;
  }
  __syncthreads();
  for (int jj = ty; jj < 32; jj += 8) {
    const int j = j0 + jj, c = c0 + tx;
    if (j < wp && c < cip) {
      uint32_t hi, lo;
      split_tf32(tile[tx][jj], hi, lo);
      const size_t at = (((size_t)n * hp + i) * wp + j) * cip + c;
      x_hi[at] = __uint_as_float(hi);
      x_lo[at] = __uint_as_float(lo);
    }
  }
}

// kp [16, co, ci] -> kp_hi, kp_lo [16, cop, cip], zero-padded
__global__ void __launch_bounds__(256)
subpixel_upconv_f32_kernel_split_k(const float* __restrict__ kp, float* __restrict__ k_hi,
                                   float* __restrict__ k_lo, int co, int ci, int cop, int cip) {
  const size_t total = (size_t)16 * cop * cip;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cip), o = (int)((idx / cip) % cop), tap = (int)(idx / ((size_t)cip * cop));
    const float v = c < ci && o < co ? kp[((size_t)tap * co + o) * ci + c] : 0.0f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    k_hi[idx] = __uint_as_float(hi);
    k_lo[idx] = __uint_as_float(lo);
  }
}

template <int WBOX>
__global__ void __launch_bounds__(THREADS, 1)
subpixel_upconv_f32_kernel(__grid_constant__ const CUtensorMap map_xh,  // x_hi [N, hp, wp, cip]
                           __grid_constant__ const CUtensorMap map_xl,  // x_lo
                           __grid_constant__ const CUtensorMap map_kh,  // kp_hi [16, cop, cip]
                           __grid_constant__ const CUtensorMap map_kl,  // kp_lo
                           const float* __restrict__ bias,             // [co]
                           float* __restrict__ half0,                  // [2, N, co, h, w]
                           float* __restrict__ out,                    // [N, co, 2h, 2w]
                           int ci, int co, int h, int w, int row_tiles, int segs) {
  constexpr int R = BN / WBOX;  // image rows per tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int seg = blockIdx.x % segs;
  const int rt = (blockIdx.x / segs) % row_tiles;
  const int n = blockIdx.x / (segs * row_tiles), N = gridDim.x / (segs * row_tiles);
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
      prefetch_tensormap(&map_xh);
      prefetch_tensormap(&map_xl);
      prefetch_tensormap(&map_kh);
      prefetch_tensormap(&map_kl);
      int stage = 0;
      uint32_t phase = 0;
      for (int px = 0; px < 2; ++px)
        for (int tap = 0; tap < 4; ++tap)
          for (int kc = 0; kc < kc_n; ++kc) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
            unsigned char* a = smem + stage * STAGE_BYTES;
            const int r = tap >> 1, s = tap & 1, p = (2 * py + px) * 4 + tap;
            tma_load_3d(a, &map_kh, &full[stage], kc * BK, o0, p);
            tma_load_3d(a + A_BYTES, &map_kl, &full[stage], kc * BK, o0, p);
            tma_load_4d(a + 2 * A_BYTES, &map_xh, &full[stage], kc * BK, j0 + px - 1 + s,
                        i0 + py - 1 + r, n);
            tma_load_4d(a + 2 * A_BYTES + B_BYTES, &map_xl, &full[stage], kc * BK,
                        j0 + px - 1 + s, i0 + py - 1 + r, n);
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
    // accumulator layout of m64nNk8: d[4j + 2h + e] is row 16*warp + lane/4 + 8h,
    // column 8j + 2*(lane%4) + e
    const int row_base = g * 64 + (lt >> 5) * 16 + (lane >> 2);
    float bo[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int o = o0 + row_base + 8 * hh;
      bo[hh] = o < co ? bias[o] : 0.0f;
    }

    // the products of PROMOTE stages go to acc, fresh each time, which is then
    // added into total with fp32 adds: the tensor cores' own accumulation
    // truncates, and over 4 x ci / 8 steps into one accumulator that error
    // grows past the fp32 bar at ci = 512
    float acc[64], total[64];
    int stage = 0, pending = -1;  // pending: a stage whose wgmma group may still run
    uint32_t phase = 0;
    const int ksteps = 4 * kc_n;
    const long long w2 = 2LL * w, h2 = 2LL * h;
    const bool even = (w & 1) == 0;  // 8- and 16-byte aligned rows
#pragma unroll 1
    for (int px = 0; px < 2; ++px) {
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] = 0.0f;
#pragma unroll 1
      for (int it = 0; it < ksteps; ++it) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_hi = smem_u32(smem + stage * STAGE_BYTES) + g * 64 * BK * 4;
        const uint32_t a_lo = a_hi + A_BYTES;
        const uint32_t b_hi = smem_u32(smem + stage * STAGE_BYTES + 2 * A_BYTES);
        const uint32_t b_lo = b_hi + B_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 8; ++k) {
          // the small terms first, then hi*hi
          wgmma_tf32_n128(acc, make_desc(a_lo + k * 32, 16, 1024),
                          make_desc(b_hi + k * 32, 16, 1024), (it % PROMOTE > 0 || k > 0) ? 1 : 0);
          wgmma_tf32_n128(acc, make_desc(a_hi + k * 32, 16, 1024),
                          make_desc(b_lo + k * 32, 16, 1024), 1);
          wgmma_tf32_n128(acc, make_desc(a_hi + k * 32, 16, 1024),
                          make_desc(b_hi + k * 32, 16, 1024), 1);
        }
        wgmma_commit();
        if (it % PROMOTE == PROMOTE - 1 || it == ksteps - 1) {
          wgmma_wait<0>();
          fence_regs(acc);
          if (lt == 0) {
            if (pending >= 0) mbar_arrive(&empty[pending]);
            mbar_arrive(&empty[stage]);
          }
          pending = -1;
#pragma unroll
          for (int i = 0; i < 64; ++i) total[i] += acc[i];
        } else {
          // one group in flight: the previous stage's is done
          wgmma_wait<1>();
          fence_regs(acc);
          if (lt == 0 && pending >= 0) mbar_arrive(&empty[pending]);
          pending = stage;
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // source pixels q, q+1 of a tile row: after px 0 into half0 [py, N, co, h, w],
      // after px 1 with half0's pair as output columns 2q ... 2q + 3 of row 2i + py
      // (whole 16-byte vectors: single floats at stride 2 from each px cost a
      // partial-sector write to device memory twice over)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int q = 8 * j + 2 * (lane & 3);
        const int t = q / WBOX, jg = j0 + q % WBOX, i = i0 + t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = o0 + row_base + 8 * hh;
          if (o >= co || i >= h || jg >= w) continue;
          const bool pair = jg + 1 < w;
          float* h0 = half0 + ((((long long)py * N + n) * co + o) * h + i) * w + jg;
          const float v0 = total[4 * j + 2 * hh] + bo[hh];
          const float v1 = total[4 * j + 2 * hh + 1] + bo[hh];
          if (px == 0) {
            if (even && pair) {
              *reinterpret_cast<float2*>(h0) = make_float2(v0, v1);
            } else {
              h0[0] = v0;
              if (pair) h0[1] = v1;
            }
          } else {
            float* dst = out + (((long long)n * co + o) * h2 + 2 * i + py) * w2 + 2 * jg;
            if (even && pair) {
              const float2 p0 = *reinterpret_cast<const float2*>(h0);
              *reinterpret_cast<float4*>(dst) = make_float4(p0.x, v0, p0.y, v1);
            } else {
              dst[0] = h0[0];
              dst[1] = v0;
              if (pair) {
                dst[2] = h0[1];
                dst[3] = v1;
              }
            }
          }
        }
      }
    }
  }
}

template <int WBOX>
int launch(const CUtensorMap (&maps)[4], const float* bias, float* half0, float* out, int ci,
           int co, int h, int w, int row_tiles, int segs, dim3 grid, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_ready{0};
  const int rc = allow_dynamic_smem(subpixel_upconv_f32_kernel<WBOX>, SMEM_BYTES, smem_ready);
  if (rc != 0) return rc;
  subpixel_upconv_f32_kernel<WBOX><<<grid, THREADS, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, half0, out, ci, co, h, w, row_tiles, segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [N, ci, h, w] fp32 NCHW, kp [4, 2, 2, co, ci] fp32, bias [co] fp32, out
// [N, co, 2h, 2w] fp32, all contiguous; x_hi, x_lo [N, hp, wp, cip] and k_hi,
// k_lo [16, cop, cip] fp32 scratch that the pre-passes fill, half0 [2, N, co, h,
// w] fp32 scratch for the px = 0 results of each py. `plan` holds the 24
// values of ops/upsample_conv.UpconvPlan.c_values for 4-byte elements (dims
// (cip, wp, hp, N) and (cip, cop, 16), byte strides, boxes (32, w_box,
// 128 / w_box, 1) and (32, 128, 1), the grid, row_tiles, segs). Returns a
// cudaError_t.
extern "C" int subpixel_upconv_f32(const void* x, const void* kp, const void* bias, void* out,
                                   void* x_hi, void* x_lo, void* k_hi, void* k_lo, void* half0,
                                   int N, int ci, int co, int h, int w, const uint64_t* plan,
                                   void* stream) {
  const uint64_t *xd = plan, *xs = plan + 4, *xb = plan + 7, *kd = plan + 11, *ks = plan + 14,
                 *kb = plan + 16, *grid = plan + 19;
  const int row_tiles = (int)plan[22], segs = (int)plan[23];
  const int w_box = (int)xb[1];
  const int cip = (int)xd[0], wp = (int)xd[1], hp = (int)xd[2], cop = (int)kd[1];
  if (N <= 0 || ci <= 0 || co <= 0 || h <= 0 || w <= 0 || xb[0] != BK || w_box < 8 ||
      w_box > 128 || (w_box & (w_box - 1)) != 0 || xb[2] * w_box != BN || xb[3] != 1 ||
      kb[0] != BK || kb[1] != BM || kb[2] != 1 || kd[0] != xd[0] || xd[3] != (uint64_t)N ||
      cip < ci || wp < w || hp < h || cop < co || grid[0] != xd[3] * row_tiles * segs ||
      grid[2] != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  int rc = encode_f32_map(&maps[0], x_hi, 4, xd, xs, xb);
  if (rc == 0) rc = encode_f32_map(&maps[1], x_lo, 4, xd, xs, xb);
  if (rc == 0) rc = encode_f32_map(&maps[2], k_hi, 3, kd, ks, kb);
  if (rc == 0) rc = encode_f32_map(&maps[3], k_lo, 3, kd, ks, kb);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const int cblocks = (cip + 31) / 32;
  const dim3 sgrid((unsigned)((wp + 31) / 32), (unsigned)hp, (unsigned)(N * cblocks));
  subpixel_upconv_f32_kernel_split_x<<<sgrid, dim3(32, 8), 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(x_hi), static_cast<float*>(x_lo), ci, h,
      w, cip, hp, wp, cblocks);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const size_t k_total = (size_t)16 * cop * cip;
  const unsigned k_blocks = (unsigned)(k_total / 256 < 1024 ? (k_total + 255) / 256 : 1024);
  subpixel_upconv_f32_kernel_split_k<<<k_blocks, 256, 0, st>>>(
      static_cast<const float*>(kp), static_cast<float*>(k_hi), static_cast<float*>(k_lo), co, ci,
      cop, cip);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* hf = static_cast<float*>(half0);
  const dim3 g((unsigned)grid[0], (unsigned)grid[1], (unsigned)grid[2]);
  switch (w_box) {
    case 8: return launch<8>(maps, b, hf, o, ci, co, h, w, row_tiles, segs, g, st);
    case 16: return launch<16>(maps, b, hf, o, ci, co, h, w, row_tiles, segs, g, st);
    case 32: return launch<32>(maps, b, hf, o, ci, co, h, w, row_tiles, segs, g, st);
    case 64: return launch<64>(maps, b, hf, o, ci, co, h, w, row_tiles, segs, g, st);
    default: return launch<128>(maps, b, hf, o, ci, co, h, w, row_tiles, segs, g, st);
  }
}
