// K3, fp32: flash attention forward, q [B*H, Tq, D], k and v [B*H, Tk, D] float32,
// no mask, D % 4 == 0, D <= 512, on the tensor cores in 3xTF32.
//
// Replaces bbdm_tpu/ops/flash_attention.py:flash_attention for fp32 inputs (the
// Pallas _kernel takes any dtype: it scales q and k by D^-1/4 in fp32, keeps the
// running max, denominator and accumulator in fp32 and writes q's dtype).
//
// Arithmetic: both products in 3xTF32. Each operand is split in registers as
// a = hi + lo, hi = tf32_rna(a), lo = tf32_rna(a - hi) (ops.split_tf32 is the
// plain version), and each product is lo*hi + hi*lo + hi*hi on the TF32 tensor
// cores, accumulated in fp32: ~2^-22 of each product is dropped, where one TF32
// pass keeps 2^-11 and misses the fp32 bar (1e-5 + 1e-4|ref|) by 7-18x. It is
// the arithmetic of PyTorch's memory-efficient attention for fp32
// (OpMultiplyAddFastF32). The softmax is an online fp32 softmax with expf.
//
// What bounds it on the H100: tensor-core operations. At the VQGAN's mid_attn_1
// shape [8, 1, 4096, 512] it does 4*T*T*D = 275 GFLOP, three TF32 passes: 1.67
// ms at 495 TFLOP/s (4.10 ms as fp32 FMAs at 67 TFLOP/s), against 268 MB read
// and written (80 us).
//
// Design: mma.sync m16n8k8 TF32 fed by TMA through an mbarrier ring, not wgmma.
// At D=512 in fp32 a block's state is large: 64 query rows of Q are 128 KB and
// their output accumulator another 128 KB. The accumulator has to live in
// registers and Q in shared memory, which leaves ~99 KB of shared memory for
// keys and values. A wgmma B operand comes from shared memory, so 3xTF32 would
// need hi and lo of each K and V tile there (8 KB per key each): ~8-key tiles
// and m64n8 instructions. mma.sync takes both operands from registers, so
// shared memory holds the raw fp32 tiles (2 KB per key) and the split happens
// in registers.
// - Pre-pass (flash_attention_f32_kernel_stage, one launch for q, one for k and
//   v): q and k times D^-1/4 in fp32, as _kernel scales them, into scratch
//   [BH, Tqm, Dm] and [BH, Tkm, Dm]; zero-padded (and v copied) only where Tk
//   < 64 or D < 32, so that every TMA box fits its tensor.
// - A block owns 64 query rows of one (batch, head): 256 threads, 8 warps. It
//   holds Q (64 x DP, DP = D rounded up to 128, 256 or 512) in shared memory,
//   in [64 x 32] boxes with the 128-byte swizzle, which makes every fragment
//   load below conflict-free.
// - Thread 0 also streams K and V tiles of 16 keys, alternately, through a
//   3-slot ring (DP / 32 boxes of [16 x 32] per tile, 32 KB at DP=512), with a
//   full and an empty mbarrier per slot: V_{j+1} into K_j's slot once the warps
//   have read the exchange there, K_{j+1} into V_{j-1}'s slot at tile j's first
//   barrier. There is no producer warp: a ninth warp puts three warps on one
//   of the SM's four register files, and ptxas then caps every thread at 168
//   registers (1 KB of spill a thread at DP=512); with 8 warps the cap is
//   255. Smem at DP=512: 128 KB + 96 KB + barriers (230,456 bytes).
// - Warp w owns 32 query rows (two m16 row blocks, 32 (w % 2) ...) and the
//   head-dim quarter h = w / 2. S = Q K^T: each warp multiplies its depth
//   quarter (A from Q, B from K; each K fragment, split once, serves both row
//   blocks), the four warps of a row pair add their partials through the K
//   slot once every warp has read it, each in the same order, so all four hold
//   the same S and run the same online softmax on their 32 x 16 scores.
// - O = O * alpha + P V: P is split in registers and is the A operand as it
//   lies. The accumulator layout holds keys 2t, 2t+1 where the A layout wants k
//   index t, t+4, so the B fragment reads V at keys 2t and 2t+1 for k index t
//   and t+4: the key order inside each 8-key step is permuted on both sides,
//   with no shuffle and no transpose of V. Each V fragment, split once, serves
//   both row blocks; each warp keeps 32 rows x DP / 4 columns of O in
//   registers (128 floats at DP=512).
// Query rows past Tq read zeros and are not written; keys past Tk are masked by
// count (a padded k's zero rows never enter the sum).
// ptxas (CUDA 12.9): 255 registers and 144 bytes of spill at DP=512, 250 at 256,
// 204 at 128 (the build log in _build/). Half the warps covering 16 rows with
// a head-dim half each (the first design) ran 11% slower: every V and K
// fragment was split for 16 rows; a quarter of the head dim over 16 warps
// capped registers at 128 and spilled 692 bytes.
// What holds it back: mma.sync rather than wgmma; the split costs ~5
// instructions per operand value (Q's fragments again for every key tile);
// the exchange puts two block-wide barriers in every key tile, so the tensor
// cores idle through the softmax; 8 warps per SM hide little latency.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 16;       // keys per K or V tile
constexpr int SLOTS = 3;      // K and V tiles in flight, alternately
constexpr int THREADS = 256;  // 8 warps; thread 0 also issues the TMA loads
constexpr int Q_CHUNK = BQ * 128;        // one [64 x 32] fp32 TMA box
constexpr int KV_CHUNK = BKV * 128;      // one [16 x 32] fp32 TMA box

// a ring slot holds a K or V tile, and the 16 KB of score partials (8 warps x
// 32 rows x 16 keys) once its K tile is read
__host__ __device__ constexpr int slot_bytes(int DP) {
  return (DP / 32) * KV_CHUNK > 16384 ? (DP / 32) * KV_CHUNK : 16384;
}

__host__ __device__ constexpr int smem_bytes(int DP) {
  // Q, the ring, 1 + 2 * SLOTS mbarriers, alignment slack
  return (DP / 32) * Q_CHUNK + SLOTS * slot_bytes(DP) + (1 + 2 * SLOTS) * 8 + 1024;
}

__device__ __forceinline__ float lds(const unsigned char* tile, int row, int col) {
  return *reinterpret_cast<const float*>(tile + swz128_f32(row, col));
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
}

// lo*hi + hi*lo + hi*hi: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// a (times scale) and, where bs is given, b into [BH, Tm, Dm], zero outside
// [T, D]: q alone, or k with v
__global__ void __launch_bounds__(256)
flash_attention_f32_kernel_stage(const float4* __restrict__ a, const float4* __restrict__ b,
                                 float4* __restrict__ as, float4* __restrict__ bs, int BH, int T,
                                 int D, int Tm, int Dm, float scale) {
  const int D4 = D / 4, Dm4 = Dm / 4;
  const size_t total = (size_t)BH * Tm * Dm4;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int d4 = (int)(idx % Dm4);
    const int r = (int)((idx / Dm4) % Tm);
    const size_t n = idx / ((size_t)Dm4 * Tm);
    const bool inside = r < T && d4 < D4;
    const size_t src = (n * T + r) * D4 + d4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    as[idx] = inside ? scaled(a[src], scale) : zero;
    if (bs != nullptr) bs[idx] = inside ? b[src] : zero;
  }
}

// one launch of the pre-pass over [BH, Tm, Dm]
int stage(const void* a, const void* b, void* as, void* bs, int BH, int T, int D, int Tm, int Dm,
          float scale, cudaStream_t st) {
  const size_t total4 = (size_t)BH * Tm * (Dm / 4);
  const unsigned blocks = (unsigned)(total4 / 256 < 4096 ? (total4 + 255) / 256 : 4096);
  flash_attention_f32_kernel_stage<<<blocks, 256, 0, st>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b), static_cast<float4*>(as),
      static_cast<float4*>(bs), BH, T, D, Tm, Dm, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_k,
                           __grid_constant__ const CUtensorMap map_v, float* __restrict__ out,
                           int Tq, int Tk, int D) {
  constexpr int NCH = DP / 32;    // 32-column boxes of a row
  constexpr int HCH = NCH / 4;    // boxes of one head-dim quarter
  constexpr int DW = DP / 4;      // head-dim columns of O per warp
  constexpr int NB = DW / 8;      // 8-column blocks of O per warp
  constexpr int SLOT = slot_bytes(DP);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;
  unsigned char* ring = smem + NCH * Q_CHUNK;  // slot s at + s * SLOT
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + SLOTS * SLOT);
  uint64_t *full = qfull + 1, *empty = full + SLOTS;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int ntiles = (Tk + BKV - 1) / BKV;

  // load idx of the sequence K0, V0, K1, V1, ... into its slot once the slot's
  // previous tile (idx - SLOTS) is released by all 8 warps; thread 0 only
  auto produce = [&](int idx) {
    if (idx >= 2 * ntiles) return;
    const int slot = idx % SLOTS;
    if (idx >= SLOTS) mbar_wait(&empty[slot], ((idx - SLOTS) / SLOTS) & 1);
    mbar_arrive_expect_tx(&full[slot], NCH * KV_CHUNK);
    const CUtensorMap* map = (idx & 1) ? &map_v : &map_k;
    for (int c = 0; c < NCH; ++c)
      tma_load_3d(ring + slot * SLOT + c * KV_CHUNK, map, &full[slot], c * 32, (idx >> 1) * BKV,
                  bh);
  };
  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);  // one arrival per warp
    }
    mbar_fence_init();
    prefetch_tensormap(&map_q);
    prefetch_tensormap(&map_k);
    prefetch_tensormap(&map_v);
    mbar_arrive_expect_tx(qfull, NCH * Q_CHUNK);
    for (int c = 0; c < NCH; ++c) tma_load_3d(Qs + c * Q_CHUNK, &map_q, qfull, c * 32, q0, bh);
    for (int idx = 0; idx < SLOTS; ++idx) produce(idx);
  }
  __syncthreads();

  // the warp index through a shuffle, so the compiler knows it is warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // rows 32 rp ... 32 rp + 31 (row blocks mb = 0, 1 of 16), head-dim quarter h
  const int rp = warp & 1, h = warp >> 1;
  const int r0 = 32 * rp + g;  // this lane's rows r0 + 16 mb + 8 hh
  float o[2][NB][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mb][i][e] = 0.0f;
  float m[2][2], l[2][2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m[mb][hh] = -INFINITY, l[mb][hh] = 0.0f;

  mbar_wait(qfull, 0);
#pragma unroll 1
  for (int j = 0; j < ntiles; ++j) {
    // ---- S = Q K^T over this warp's depth quarter, 32 rows x 16 keys
    const int ks = (2 * j) % SLOTS;
    mbar_wait(&full[ks], ((2 * j) / SLOTS) & 1);
    const unsigned char* kt = ring + ks * SLOT;
    float s[2][2][4];  // [row block][key block][accumulator]
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mb][nb][e] = 0.0f;
#pragma unroll 2
    for (int cc = 0; cc < HCH; ++cc) {
      const int c = h * HCH + cc;
      const unsigned char* qc = Qs + c * Q_CHUNK;
      const unsigned char* kc = kt + c * KV_CHUNK;
#pragma unroll
      for (int kk = 0; kk < 32; kk += 8) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          const int r = r0 + 16 * mb;
          const float a[4] = {lds(qc, r, kk + t), lds(qc, r + 8, kk + t), lds(qc, r, kk + t + 4),
                              lds(qc, r + 8, kk + t + 4)};
          split4(a, ahi[mb], alo[mb]);
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(lds(kc, 8 * nb + g, kk + t), bh0, bl0);
          split_tf32(lds(kc, 8 * nb + g, kk + t + 4), bh1, bl1);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) mma3(s[mb][nb], ahi[mb], alo[mb], bh0, bh1, bl0, bl1);
        }
      }
    }
    // the four partials of each row pair through the K slot, once every warp
    // has read it; the four warps of a row pair sum them in the same order, so
    // all hold the same S
    named_barrier(1, THREADS);
    // every warp is done with tile j - 1's V: K_{j+1} into its slot
    if (tid == 0 && j > 0) produce(2 * j + 2);
    __syncwarp();
    float* X = reinterpret_cast<float*>(ring + ks * SLOT);
#pragma unroll
    for (int i = 0; i < 16; ++i) X[warp * 512 + i * 32 + lane] = s[i / 8][(i / 4) % 2][i % 4];
    named_barrier(2, THREADS);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float sum = X[rp * 512 + i * 32 + lane];
#pragma unroll
      for (int p = 1; p < 4; ++p) sum += X[(rp + 2 * p) * 512 + i * 32 + lane];
      s[i / 8][(i / 4) % 2][i % 4] = sum;
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[ks]);
    // V_{j+1} into this K slot once every warp has read the exchange (a short
    // wait: all are past the barrier above)
    if (tid == 0) produce(2 * j + 3);
    __syncwarp();

    // ---- online softmax of rows r0 + 16 mb (s[mb][.][0, 1]) and r0 + 16 mb + 8
    // (s[mb][.][2, 3]); keys past Tk only in the last tile
    if (j == ntiles - 1) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * BKV + 8 * nb + 2 * t + e >= Tk)
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) s[mb][nb][e] = s[mb][nb][2 + e] = -INFINITY;
    }
    float alpha[2][2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(fmaxf(s[mb][0][2 * hh], s[mb][0][2 * hh + 1]),
                         fmaxf(s[mb][1][2 * hh], s[mb][1][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mb][hh], mx);  // finite: every tile holds a key < Tk
        alpha[mb][hh] = expf(m[mb][hh] - m_new);
        m[mb][hh] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& p = s[mb][nb][2 * hh + e];
            p = expf(p - m_new);
            sum += p;
          }
        l[mb][hh] = l[mb][hh] * alpha[mb][hh] + sum;
      }
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        o[mb][i][0] *= alpha[mb][0];
        o[mb][i][1] *= alpha[mb][0];
        o[mb][i][2] *= alpha[mb][1];
        o[mb][i][3] *= alpha[mb][1];
      }
    // P as the A operand of each 8-key step: k index t holds key 2t, t + 4 key 2t + 1
    uint32_t phi[2][2][4], plo[2][2][4];  // [row block][key block]
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const float a[4] = {s[mb][kb][0], s[mb][kb][2], s[mb][kb][1], s[mb][kb][3]};
        split4(a, phi[mb][kb], plo[mb][kb]);
      }

    // ---- O += P V over this warp's head-dim quarter: each V fragment, split
    // once, serves both row blocks
    const int vsl = (2 * j + 1) % SLOTS;
    mbar_wait(&full[vsl], ((2 * j + 1) / SLOTS) & 1);
    const unsigned char* vt = ring + vsl * SLOT;
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int col = h * DW + 8 * i + g;
        const unsigned char* vc = vt + (col >> 5) * KV_CHUNK;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(lds(vc, 8 * kb + 2 * t, col & 31), bh0, bl0);
        split_tf32(lds(vc, 8 * kb + 2 * t + 1, col & 31), bh1, bl1);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
          mma3(o[mb][i], phi[mb][kb], plo[mb][kb], bh0, bh1, bl0, bl1);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[vsl]);
  }

#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[mb][hh] += __shfl_xor_sync(0xffffffffu, l[mb][hh], 1);
      l[mb][hh] += __shfl_xor_sync(0xffffffffu, l[mb][hh], 2);
    }
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 16 * mb + 8 * hh;
      if (row >= Tq) continue;
      float* dst = out + ((size_t)bh * Tq + row) * D;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int col = h * DW + 8 * i + 2 * t;
        if (col < D)  // D % 4 == 0, so col + 1 < D too
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[mb][i][2 * hh] / l[mb][hh], o[mb][i][2 * hh + 1] / l[mb][hh]);
      }
    }
}

template <int DP>
int launch(const CUtensorMap (&maps)[3], float* out, int BH, int Tq, int Tk, int D,
           cudaStream_t stream) {
  static std::atomic<uint64_t> smem_ready{0};
  const int rc = allow_dynamic_smem(flash_attention_f32_kernel<DP>, smem_bytes(DP), smem_ready);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((Tq + BQ - 1) / BQ), (unsigned)BH);
  flash_attention_f32_kernel<DP><<<grid, THREADS, smem_bytes(DP), stream>>>(
      maps[0], maps[1], maps[2], out, Tq, Tk, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [BH, Tq, D] and k, v: [BH, Tk, D] fp32 contiguous, D % 4 == 0, 0 < D <= 512,
// Tq, Tk >= 1. qs: [BH, Tqm, Dm] and ks: [BH, Tkm, Dm] fp32 scratch with Tqm =
// max(Tq, 64), Tkm = max(Tk, 64), Dm = max(D, 32); vs like ks where (Tkm, Dm) !=
// (Tk, D), else null (v is read in place). smem is the caller's copy of the
// shared-memory size (ops/attention.flash_f32_smem_bytes); a mismatch is refused.
// Returns a cudaError_t.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   void* qs, void* ks, void* vs, int BH, int Tq, int Tk, int D,
                                   int Tqm, int Tkm, int Dm, int smem, void* stream) {
  if (D % 4 != 0 || D <= 0 || D > 512 || Tq <= 0 || Tk <= 0 || BH <= 0 ||
      Tqm != (Tq > 64 ? Tq : 64) || Tkm != (Tk > 64 ? Tk : 64) || Dm != (D > 32 ? D : 32) ||
      (vs == nullptr && (Tkm != Tk || Dm != D)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int DP = Dm <= 128 ? 128 : Dm <= 256 ? 256 : 512;
  if (smem != smem_bytes(DP)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // D^-1/4 in double, rounded once to fp32, as the Python scale of the JAX kernel
  const float scale = static_cast<float>(1.0 / pow((double)D, 0.25));
  int rc = stage(q, nullptr, qs, nullptr, BH, Tq, D, Tqm, Dm, scale, st);
  if (rc != 0) return rc;
  rc = stage(k, v, ks, vs, BH, Tk, D, Tkm, Dm, scale, st);
  if (rc != 0) return rc;

  CUtensorMap maps[3];
  const void* ptrs[3] = {qs, ks, vs != nullptr ? vs : v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t rows = (uint64_t)(i == 0 ? Tqm : Tkm);
    const uint64_t dims[3] = {(uint64_t)Dm, rows, (uint64_t)BH};
    const uint64_t strides[2] = {(uint64_t)Dm * 4, rows * Dm * 4};
    const uint64_t box[3] = {32, (uint64_t)(i == 0 ? BQ : BKV), 1};
    rc = encode_f32_map(&maps[i], ptrs[i], 3, dims, strides, box);
    if (rc != 0) return rc;
  }
  float* o = static_cast<float*>(out);
  if (DP == 128) return launch<128>(maps, o, BH, Tq, Tk, D, st);
  if (DP == 256) return launch<256>(maps, o, BH, Tq, Tk, D, st);
  return launch<512>(maps, o, BH, Tq, Tk, D, st);
}
