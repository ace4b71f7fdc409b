// K3: flash attention forward, [B*H, T, D] bf16, no mask, head dim up to 512.
//
// Replaces bbdm_tpu/ops/flash_attention.py:flash_attention (the Pallas _kernel:
// blockwise online softmax with fp32 running max, denominator and accumulator
// in VMEM). Softmax(q k^T / sqrt(D)) v, i.e. q and k each scaled by D^-1/4.
//
// What bounds it on the H100: tensor-core FLOPs. On LBBDM-f4 it runs the VQGAN
// encoder and decoder mid_attn_1 at H=1, T=4096, D=512: 4*T*T*D = 34 GFLOP per
// (batch, head), 275 GFLOP at batch 8, against 3*T*D*2 = 12.6 MB read per head.
// The score matrix never reaches device memory.
//
// Design: D=512 is above the head dims of FlashAttention-2/3 and of SDPA's
// flash backend, and a [BQ, 512] fp32 accumulator does not fit in registers,
// so one block per (bh, 32-row query tile) keeps in dynamic shared memory
// (~176 KB at D=512, set with cudaFuncAttributeMaxDynamicSharedMemorySize):
// the Q tile, one K/V tile of 64 keys (K, then V, in the same buffer), the
// fp32 O accumulator, the fp32 score tile, the bf16 probability tile and the
// per-row running max / sum. Per key tile: 8 warps compute S = Q K^T with
// bf16 WMMA 16x16x16 (fp32 accumulate), one warp per 16x16 tile; each warp
// then updates 4 rows of the online softmax with shuffles; O is rescaled by
// exp(m_old - m_new) in shared memory, V is loaded over K, and the warps add
// P V into their 16x16 slices of O through accumulator fragments. The final
// pass divides by the row sums and writes bf16. Keys past T are masked to
// -inf, query rows past T are not written. Pipelining K/V loads and keeping O
// in registers with wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int S_LD = BKV + 4;  // fp32 score tile stride
constexpr int P_LD = BKV + 8;  // bf16 probability tile stride

struct Smem {
  int d_ld, o_ld;
  size_t q, kv, o, s, p, stats, bytes;
  __host__ __device__ explicit Smem(int D) {
    d_ld = D + 8;
    o_ld = D + 4;
    q = 0;
    kv = q + (size_t)BQ * d_ld * 2;
    o = kv + (size_t)BKV * d_ld * 2;
    s = o + (size_t)BQ * o_ld * 4;
    p = s + (size_t)BQ * S_LD * 4;
    stats = p + (size_t)BQ * P_LD * 2;
    bytes = stats + 3 * BQ * 4;
  }
};

// rows [row0, row0 + rows) of a [T, D] bf16 matrix into smem with stride ld; zero past T
__device__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int rows,
                          int T, int D, int ld) {
  const int vec_per_row = D / 8;
  for (int v = threadIdx.x; v < rows * vec_per_row; v += THREADS) {
    const int r = v / vec_per_row;
    const int c8 = (v % vec_per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c8);
    *reinterpret_cast<uint4*>(dst + r * ld + c8) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int T, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem L(D);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.q);
  __nv_bfloat16* KVs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.kv);
  float* Os = reinterpret_cast<float*>(smem_raw + L.o);
  float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.p);
  float* m_s = reinterpret_cast<float*>(smem_raw + L.stats);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t head = (size_t)blockIdx.y * T * D;
  const int q0 = blockIdx.x * BQ;

  load_tile(Qs, q + head, q0, BQ, T, D, L.d_ld);
  for (int i = tid; i < BQ * D; i += THREADS) Os[(i / D) * L.o_ld + i % D] = 0.0f;
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }

  for (int k0 = 0; k0 < T; k0 += BKV) {
    load_tile(KVs, k + head, k0, BKV, T, D, L.d_ld);
    __syncthreads();

    {  // S = Q K^T: (BQ/16) x (BKV/16) = 8 tiles, one per warp
      const int tr = warp / (BKV / 16), tc = warp % (BKV / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.0f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + tr * 16 * L.d_ld + kk, L.d_ld);
        wmma::load_matrix_sync(b, KVs + tc * 16 * L.d_ld + kk, L.d_ld);
        wmma::mma_sync(sacc, a, b, sacc);
      }
      wmma::store_matrix_sync(Ss + tr * 16 * S_LD + tc * 16, sacc, S_LD, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax: each warp owns BQ / NWARPS rows, each lane two keys
    for (int rr = 0; rr < BQ / NWARPS; ++rr) {
      const int row = warp * (BQ / NWARPS) + rr;
      float s0 = Ss[row * S_LD + lane] * scale;
      float s1 = Ss[row * S_LD + lane + 32] * scale;
      if (k0 + lane >= T) s0 = -INFINITY;
      if (k0 + lane + 32 >= T) s1 = -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[row * P_LD + lane] = __float2bfloat16(p0);
      Ps[row * P_LD + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();  // all reads of K done, all alphas written

    load_tile(KVs, v + head, k0, BKV, T, D, L.d_ld);
    for (int i = tid; i < BQ * D; i += THREADS) Os[(i / D) * L.o_ld + i % D] *= a_s[i / D];
    __syncthreads();

    // O += P V: (BQ/16) x (D/16) tiles of 16 x 16, strided over the warps
    for (int t = warp; t < (BQ / 16) * (D / 16); t += NWARPS) {
      const int tr = t / (D / 16), tc = t % (D / 16);
      float* o_tile = Os + tr * 16 * L.o_ld + tc * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, o_tile, L.o_ld, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + tr * 16 * P_LD + kk, P_LD);
        wmma::load_matrix_sync(b, KVs + kk * L.d_ld + tc * 16, L.d_ld);
        wmma::mma_sync(oacc, a, b, oacc);
      }
      wmma::store_matrix_sync(o_tile, oacc, L.o_ld, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = i / D, c = i % D;
    if (q0 + row < T)
      out[head + (size_t)(q0 + row) * D + c] = __float2bfloat16(Os[row * L.o_ld + c] / l_s[row]);
  }
}

}  // namespace

// q, k, v, out: [BH, T, D] bf16 contiguous. Requires D % 16 == 0 and D <= 512
// (checked by the Python wrapper).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int BH, int T, int D, void* stream) {
  const Smem L(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)((T + BQ - 1) / BQ), (unsigned)BH);
  flash_attention_kernel<<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, D,
      1.0f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}
