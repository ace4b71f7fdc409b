// K3, fp32: flash attention forward, [B*H, T, D] float32, no mask, D % 4 == 0, D <= 512.
//
// Replaces bbdm_tpu/ops/flash_attention.py:flash_attention for fp32 inputs (the
// Pallas _kernel takes any dtype: it scales q and k by D^-1/4 in fp32, keeps the
// running max, denominator and accumulator in fp32 and writes q's dtype). This
// entry computes exactly that arithmetic in fp32: both products are fp32 FMAs
// (no TF32, which would not compute what the Pallas kernel computes), the
// softmax is an online softmax with expf.
//
// What bounds it on the H100: fp32 operations. At the VQGAN's mid_attn_1 shape
// [8, 1, 4096, 512] it does 4*T*T*D = 34 GFLOP per (batch, head), 275 GFLOP in
// all: 4.10 ms at 67 TFLOP/s, against 268 MB read and written (80 us).
//
// Design: a plain SIMT kernel, one 256-thread block per 32 query rows of one
// (batch, head). At D=512 an fp32 row is 2 KB, so the tile sizes follow the
// 227 KB of shared memory: Q 32 rows (64.5 KB), one K-or-V tile of 64 keys
// (129 KB; V is loaded into it once the scores are read), the 32 x 64 score
// tile (8.5 KB): 202 KB, one block per SM. The 32 x D output accumulator lives
// in registers, 8 rows x 8 columns per thread (64 floats at D=512). Per 64-key
// tile:
// - S = Q K^T: each thread owns 2 rows x 4 keys and walks the depth in float4
//   steps (6 shared loads per 32 FMAs);
// - the online softmax: 8 threads per row reduce the max and the sum with warp
//   shuffles, write the probabilities over the scores and the rescale factor;
// - O = O * alpha + P V: each thread multiplies 8 broadcast probabilities into
//   two float4 columns of V per key.
// Rows are padded to an odd number of float4 groups, so the float4 loads of 8
// consecutive rows (a quarter warp) hit distinct banks. Keys past T score -inf;
// query rows past T read zeros and are not written.
// What holds it back: no overlap of the K/V loads with the products (one tile
// buffer), one block of 8 warps per SM to hide latency, and the shared-memory
// bandwidth of the SIMT products.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 32;         // query rows per block
constexpr int BKV = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr int S_LD = BKV + 4;  // 17 float4 groups: odd

// floats per staged row of D columns: D + 4 or D + 8, an odd number of float4 groups
__host__ __device__ inline int row_ld(int D) {
  const int ld = D + 4;
  return ((ld / 4) % 2 == 0) ? ld + 4 : ld;
}

__host__ __device__ inline int smem_bytes(int D) {
  return (BQ + BKV) * row_ld(D) * 4 + BQ * S_LD * 4 + 2 * BQ * 4;
}

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// rows [r0, r0 + rows) of src [T, D] into dst [rows][ld], times `scale`; rows past T are zero
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int rows, int T, int D, int ld, float scale) {
  const int D4 = D / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rows * D4; idx += THREADS) {
    const int r = idx / D4, c4 = idx - r * D4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) v = scaled(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D)[c4], scale);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c4) = v;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int T, int D,
                           float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = row_ld(D), ld4 = ld / 4, D4 = D / 4;
  float* Qs = smem;                 // [BQ][ld]: q * D^-1/4
  float* KVs = Qs + BQ * ld;        // [BKV][ld]: k * D^-1/4, then v
  float* Ss = KVs + BKV * ld;       // [BQ][S_LD]: scores, then probabilities
  float* alpha_s = Ss + BQ * S_LD;  // [BQ]: this tile's rescale of O
  float* l_s = alpha_s + BQ;        // [BQ]: the final denominators
  const float4* Qs4 = reinterpret_cast<const float4*>(Qs);
  const float4* KVs4 = reinterpret_cast<const float4*>(KVs);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * T * D;
  q += base;
  k += base;
  v += base;
  out += base;
  load_rows(Qs, q, q0, BQ, T, D, ld, scale);

  // S: rows 2 * srg + {0, 1}, keys scg + 16 jj
  const int srg = tid / 16, scg = tid % 16;
  // softmax: row sr, keys 8 * sl ... 8 * sl + 7 (the 8 threads of a row share a warp)
  const int sr = tid / 8, sl = tid % 8;
  float m_run = -INFINITY, l_run = 0.f;
  // O: rows 8 * og ... 8 * og + 7, float4 column groups cg and cg + 64
  const int og = tid / 64, cg = tid % 64;
  const bool has0 = cg < D4, has1 = cg + 64 < D4;
  float o[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[r][c] = 0.f;

  const int ntiles = (T + BKV - 1) / BKV;
#pragma unroll 1
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // the previous tile's V and P reads are done (and Q is staged)
    load_rows(KVs, k, k0, BKV, T, D, ld, scale);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 a0 = Qs4[(2 * srg) * ld4 + d4], a1 = Qs4[(2 * srg + 1) * ld4 + d4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 b = KVs4[(scg + 16 * jj) * ld4 + d4];
        s[0][jj] = fmaf(a0.x, b.x, s[0][jj]);
        s[0][jj] = fmaf(a0.y, b.y, s[0][jj]);
        s[0][jj] = fmaf(a0.z, b.z, s[0][jj]);
        s[0][jj] = fmaf(a0.w, b.w, s[0][jj]);
        s[1][jj] = fmaf(a1.x, b.x, s[1][jj]);
        s[1][jj] = fmaf(a1.y, b.y, s[1][jj]);
        s[1][jj] = fmaf(a1.z, b.z, s[1][jj]);
        s[1][jj] = fmaf(a1.w, b.w, s[1][jj]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = scg + 16 * jj;
        Ss[(2 * srg + a) * S_LD + key] = k0 + key < T ? s[a][jj] : -INFINITY;
      }
    __syncthreads();

    // online softmax of row sr; the K tile is no longer read, so V replaces it
    float p[8];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p[e] = Ss[sr * S_LD + 8 * sl + e];
      mx = fmaxf(mx, p[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m_run, mx);  // finite: every tile holds a key < T
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p[e] = expf(p[e] - m_new);
      sum += p[e];
      Ss[sr * S_LD + 8 * sl + e] = p[e];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (sl == 0) alpha_s[sr] = alpha;
    load_rows(KVs, v, k0, BKV, T, D, ld, 1.0f);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float a = alpha_s[8 * og + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) o[r][c] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 v0 = has0 ? KVs4[kk * ld4 + cg] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 v1 = has1 ? KVs4[kk * ld4 + cg + 64] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float pr = Ss[(8 * og + r) * S_LD + kk];
        o[r][0] = fmaf(pr, v0.x, o[r][0]);
        o[r][1] = fmaf(pr, v0.y, o[r][1]);
        o[r][2] = fmaf(pr, v0.z, o[r][2]);
        o[r][3] = fmaf(pr, v0.w, o[r][3]);
        o[r][4] = fmaf(pr, v1.x, o[r][4]);
        o[r][5] = fmaf(pr, v1.y, o[r][5]);
        o[r][6] = fmaf(pr, v1.z, o[r][6]);
        o[r][7] = fmaf(pr, v1.w, o[r][7]);
      }
    }
  }

  if (sl == 0) l_s[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + 8 * og + r;
    if (row >= T) continue;
    const float l = l_s[8 * og + r];
    float4* dst = reinterpret_cast<float4*>(out + (size_t)row * D);
    if (has0) dst[cg] = make_float4(o[r][0] / l, o[r][1] / l, o[r][2] / l, o[r][3] / l);
    if (has1) dst[cg + 64] = make_float4(o[r][4] / l, o[r][5] / l, o[r][6] / l, o[r][7] / l);
  }
}

}  // namespace

// q, k, v, out: [BH, T, D] fp32 contiguous, D % 4 == 0, 0 < D <= 512, T >= 1. Returns a
// cudaError_t.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int BH, int T, int D, void* stream) {
  if (D % 4 != 0 || D <= 0 || D > 512 || T <= 0 || BH <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the attribute once per device, at the largest size any D takes
  static std::atomic<uint64_t> smem_ready{0};
  const int rc = hopper::allow_dynamic_smem(flash_attention_f32_kernel, smem_bytes(512), smem_ready);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((T + BQ - 1) / BQ), (unsigned)BH);
  // D^-1/4 in double, rounded once to fp32, as the Python scale of the JAX kernel
  const float scale = static_cast<float>(1.0 / pow((double)D, 0.25));
  flash_attention_f32_kernel<<<grid, THREADS, smem_bytes(D), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), T, D, scale);
  return static_cast<int>(cudaGetLastError());
}
