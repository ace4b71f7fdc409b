// K2, fp32: fused nearest-2x upsample + 3x3 conv (exact subpixel decomposition).
//
// Replaces bbdm_tpu/ops/subpixel_pallas.py:subpixel_upconv_pallas for fp32 inputs
// (the Pallas kernel takes any dtype: 4 phases x 2x2 taps, fp32 accumulation, the
// interleaved output written directly):
//
//   out[n, o, 2i+py, 2j+px] = b[o] + sum_{r,s,c} kp[p, r, s, o, c] * x[n, c, i+py-1+r, j+px-1+s]
//
// with p = 2*py + px, kp the fp32-combined phase kernel
// (ops/upsample_conv.combine_kernel_2x2) and zero padding. x and out are NCHW;
// taps and sums are fp32 FMAs (no TF32).
//
// What bounds it on the H100: fp32 operations. At the VQGAN decoder's shapes,
// [8, 512, 64, 64] -> 512 and [8, 256, 128, 128] -> 256, it does 2*N*h*w*16*ci*co
// = 275 GFLOP: 4.10 ms at 67 TFLOP/s, against ~0.6 GB read and written.
//
// Design: a plain SIMT implicit GEMM without TMA (the bf16 kernel's boxes and
// 128-byte swizzle are sized for 2-byte elements). A 256-thread block owns 64
// output channels x a 4 x 16 tile of source pixels of one sample, for all four
// phases, so one staged input patch (the tile and its one-pixel halo, 6 x 18)
// serves all 16 phase taps. Per stage of 8 input channels it stages that patch
// (zero outside the image: the conv's padding) and the 16 taps x 64 channels
// (taps transposed so 4 output channels are one float4). Each thread owns
// 4 output channels x 4 source pixels of one row x 4 phases (64 fp32
// accumulators): per input channel it reads its 3 x 6 neighbourhood into
// registers and 16 float4 of taps, then does 256 FMAs. The epilogue adds the
// bias and writes each (px 0, px 1) pair as one float2, so a row of 4 threads
// writes 32 consecutive floats of an output row.
// What holds it back: no overlap of the staging loads with the FMAs, and each
// block re-reads the taps of its 64 channels (2 MB at ci=512) from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 4, TW = 16;            // source pixels per block: rows x columns
constexpr int BM = 64;                    // output channels per block
constexpr int BK = 8;                     // input channels per stage
constexpr int THREADS = 256;
constexpr int XH = TH + 2, XW = TW + 2;   // the patch with its halo
constexpr int WS_LD = 16 * BM + 4;        // floats per staged input channel of taps

__global__ void __launch_bounds__(THREADS, 2)
subpixel_upconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ kp,
                           const float* __restrict__ bias, float* __restrict__ out, int ci,
                           int co, int h, int w, int row_tiles, int col_tiles) {
  __shared__ __align__(16) float xs[BK][XH][XW];
  __shared__ __align__(16) float ws[BK * WS_LD];  // [c][tap][o], tap = 4p + 2r + s

  const int tid = threadIdx.x;
  const int ct = blockIdx.x % col_tiles;
  const int rt = (blockIdx.x / col_tiles) % row_tiles;
  const int n = blockIdx.x / (col_tiles * row_tiles);
  const int i0 = rt * TH, j0 = ct * TW, o0 = blockIdx.y * BM;
  // this thread: source row tr, columns tc .. tc+3 of the tile; channels o0 + 4 og ...
  const int quad = tid % 16, og = tid / 16;
  const int tr = quad / 4, tc = (quad % 4) * 4;

  float acc[4][4][4];  // [phase][output channel][pixel]
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][a][e] = 0.f;

  const size_t plane = (size_t)h * w;
  const float* xn = x + (size_t)n * ci * plane;
#pragma unroll 1
  for (int c0 = 0; c0 < ci; c0 += BK) {
    for (int idx = tid; idx < BK * XH * XW; idx += THREADS) {
      const int c = idx / (XH * XW), rem = idx - c * (XH * XW);
      const int rr = rem / XW, cc = rem - rr * XW;
      const int gi = i0 + rr - 1, gj = j0 + cc - 1;
      float val = 0.f;
      if (c0 + c < ci && gi >= 0 && gi < h && gj >= 0 && gj < w)
        val = xn[(size_t)(c0 + c) * plane + (size_t)gi * w + gj];
      xs[c][rr][cc] = val;
    }
    // kp [16, co, ci] read along c (8 consecutive floats), stored [c][tap][o]
    for (int idx = tid; idx < 16 * BM * BK; idx += THREADS) {
      const int c = idx % BK, o = (idx / BK) % BM, tap = idx / (BK * BM);
      float val = 0.f;
      if (c0 + c < ci && o0 + o < co) val = kp[((size_t)tap * co + o0 + o) * ci + c0 + c];
      ws[c * WS_LD + tap * BM + o] = val;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float xv[3][6];  // source rows i-1 .. i+1, columns j-1 .. j+4
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 6; ++dc) xv[dr][dc] = xs[c][tr + dr][tc + dc];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int py = p >> 1, px = p & 1;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float4 wv =
                *reinterpret_cast<const float4*>(&ws[c * WS_LD + (4 * p + 2 * r + s) * BM + 4 * og]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float xval = xv[py + r][px + s + e];
              acc[p][0][e] = fmaf(wv.x, xval, acc[p][0][e]);
              acc[p][1][e] = fmaf(wv.y, xval, acc[p][1][e]);
              acc[p][2][e] = fmaf(wv.z, xval, acc[p][2][e]);
              acc[p][3][e] = fmaf(wv.w, xval, acc[p][3][e]);
            }
          }
      }
    }
    __syncthreads();
  }

  const int i = i0 + tr;
  if (i >= h) return;
  const size_t w2 = 2 * (size_t)w;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o0 + 4 * og + a;
    if (o >= co) continue;
    const float b = bias[o];
#pragma unroll
    for (int py = 0; py < 2; ++py) {
      float* row = out + (((size_t)n * co + o) * 2 * h + 2 * i + py) * w2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + tc + e;
        if (j < w)
          *reinterpret_cast<float2*>(row + 2 * j) =
              make_float2(acc[2 * py][a][e] + b, acc[2 * py + 1][a][e] + b);
      }
    }
  }
}

}  // namespace

// x [N, ci, h, w] fp32, kp [4, 2, 2, co, ci] fp32, bias [co] fp32, out [N, co, 2h, 2w]
// fp32, all contiguous. Returns a cudaError_t.
extern "C" int subpixel_upconv_f32(const void* x, const void* kp, const void* bias, void* out,
                                   int N, int ci, int co, int h, int w, void* stream) {
  if (N <= 0 || ci <= 0 || co <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (h + TH - 1) / TH, col_tiles = (w + TW - 1) / TW;
  const dim3 grid((unsigned)(N * row_tiles * col_tiles), (unsigned)((co + BM - 1) / BM));
  subpixel_upconv_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(kp),
      static_cast<const float*>(bias), static_cast<float*>(out), ci, co, h, w, row_tiles,
      col_tiles);
  return static_cast<int>(cudaGetLastError());
}
