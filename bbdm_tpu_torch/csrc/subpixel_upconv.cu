// K2: fused nearest-2x upsample + 3x3 conv (exact subpixel decomposition), NCHW, bf16.
//
// Replaces bbdm_tpu/ops/subpixel_pallas.py:subpixel_upconv_pallas (the Pallas
// _kernel: 4 phases x 2x2 taps on the MXU, fp32 accumulation, the interleaved
// [2h, 2w, co] output written directly).
//
//   out[n, o, 2i+py, 2j+px] = b[o] + sum_{r,s,c} kp[p, r, s, o, c] * x[n, c, i+py-1+r, j+px-1+s]
//
// with p = 2*py + px, kp the fp32-combined phase kernel
// (ops/upsample_conv.combine_kernel_2x2, cast to bf16) and zero padding.
//
// What bounds it on the H100: tensor-core FLOPs. At the path shapes it does
// 2*N*h*w*16*ci*co flops (275 GFLOP for the VQGAN decoder's 256->256 at
// 128^2 -> 256^2, batch 8) against ~(N*h*w*ci + 4*N*h*w*co)*2 bytes (~0.35 GB):
// ~800 flops/byte, above the ~295 where bf16 tensor cores bind.
//
// Design (simple first): an implicit GEMM per phase. Block = (64 source
// pixels, 64 output channels, one phase); the K loop runs over the phase's 4
// taps x ci in chunks of 32. The weight tile [64 co x 32 ci] is staged in
// shared memory with 16-byte loads; the input tile [32 ci x 64 px] is gathered
// with the tap's (dy, dx) shift and the conv's zero padding. Four warps each
// own a 32x32 output tile of bf16 WMMA 16x16x16 fragments with fp32
// accumulators. The epilogue adds the fp32 bias and writes every output pixel
// of the phase straight to its interleaved place, so the phase-window
// extract pass never exists. Pixels are flattened over (n, i, j), so any h, w
// and batch tile the grid. wgmma/TMA and a cp.async pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output channels per block
constexpr int BN = 64;        // source pixels per block
constexpr int BK = 32;        // input channels per K step
constexpr int THREADS = 128;  // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int A_LD = BK + 8;  // smem row strides (elements), padded against bank conflicts
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

__global__ void __launch_bounds__(THREADS)
subpixel_upconv_kernel(const __nv_bfloat16* __restrict__ x,   // [N, ci, h, w]
                       const __nv_bfloat16* __restrict__ kp,  // [4, 2, 2, co, ci]
                       const float* __restrict__ bias,        // [co]
                       __nv_bfloat16* __restrict__ out,       // [N, co, 2h, 2w]
                       int N, int ci, int co, int h, int w) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int phase = blockIdx.z;
  const int py = phase >> 1, px = phase & 1;
  const int co0 = blockIdx.y * BM;
  const long long hw = (long long)h * w;
  const long long total = (long long)N * hw;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  // this thread gathers source pixel column `col` of the B tile, rows row0, row0+2, ...
  const int col = tid % BN;
  const int row0 = tid / BN;
  const long long p = (long long)blockIdx.x * BN + col;
  const bool pvalid = p < total;
  long long pn = 0;
  int pi = 0, pj = 0;
  if (pvalid) {
    pn = p / hw;
    const long long rem = p - pn * hw;
    pi = (int)(rem / w);
    pj = (int)(rem - (long long)pi * w);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 4; ++tap) {
    const int r = tap >> 1, s = tap & 1;
    const int si = pi + py - 1 + r;
    const int sj = pj + px - 1 + s;
    const bool valid = pvalid && si >= 0 && si < h && sj >= 0 && sj < w;
    const __nv_bfloat16* xsrc = valid ? x + pn * ci * hw + (long long)si * w + sj : x;
    const __nv_bfloat16* ksrc = kp + (size_t)(phase * 4 + tap) * co * ci;

    for (int c0 = 0; c0 < ci; c0 += BK) {
      // A tile [BM co x BK ci]: 16-byte vectors, BK/8 per row
      for (int v = tid; v < BM * BK / 8; v += THREADS) {
        const int row = v / (BK / 8);
        const int c8 = (v % (BK / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (co0 + row < co)
          val = *reinterpret_cast<const uint4*>(ksrc + (size_t)(co0 + row) * ci + c0 + c8);
        *reinterpret_cast<uint4*>(&As[row * A_LD + c8]) = val;
      }
      // B tile [BK ci x BN px]: shifted gather, zero outside the image
      for (int rr = row0; rr < BK; rr += THREADS / BN) {
        __nv_bfloat16 val = __float2bfloat16(0.0f);
        if (valid) val = xsrc[(long long)(c0 + rr) * hw];
        Bs[rr * B_LD + col] = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16], acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();

  if (!pvalid) return;
  const long long w2 = 2LL * w;
  const long long plane = 4 * hw;  // (2h) * (2w)
  __nv_bfloat16* dst = out + pn * co * plane + (long long)(2 * pi + py) * w2 + 2 * pj + px;
  for (int rr = row0; rr < BM; rr += THREADS / BN) {
    const int o = co0 + rr;
    if (o < co) dst[(long long)o * plane] = __float2bfloat16(Cs[rr * C_LD + col] + bias[o]);
  }
}

}  // namespace

// x [N, ci, h, w] bf16, kp [4, 2, 2, co, ci] bf16, bias [co] fp32, out [N, co, 2h, 2w] bf16.
// Requires ci % 32 == 0 (checked by the Python wrapper).
extern "C" int subpixel_upconv_bf16(const void* x, const void* kp, const void* bias, void* out,
                                    int N, int ci, int co, int h, int w, void* stream) {
  const long long pixels = (long long)N * h * w;
  dim3 grid((unsigned)((pixels + BN - 1) / BN), (unsigned)((co + BM - 1) / BM), 4);
  subpixel_upconv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), N, ci, co, h, w);
  return static_cast<int>(cudaGetLastError());
}
