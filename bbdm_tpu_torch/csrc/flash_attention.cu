// K3: flash attention forward, q [B*H, Tq, D], k and v [B*H, Tk, D] bf16, no mask,
// head dim up to 512.
//
// Replaces bbdm_tpu/ops/flash_attention.py:flash_attention (the Pallas _kernel:
// blockwise online softmax with fp32 running max, denominator and accumulator
// in VMEM; its key grid axis runs over Tk, which may differ from Tq).
// Softmax(q k^T / sqrt(D)) v, i.e. q and k each scaled by D^-1/4.
//
// What bounds it on the H100: tensor-core FLOPs, and at small head dims the
// softmax's exponentials as much. On LBBDM-f4 it runs the VQGAN encoder and
// decoder mid_attn_1 at H=1, T=4096, D=512: 4*T*T*D = 34 GFLOP per (batch,
// head), 275 GFLOP at batch 8, against 3*T*D*2 = 12.6 MB read per head. The
// cross-attention UNet at SD v1's widths runs it at 8 heads of D = 40, 80 and 160
// over 4096, 1024 and 256 queries and 4096 keys. The score matrix never reaches
// device memory.
//
// Design. DP, the compiled head dim, is D rounded up to 64, 128, 256 or 512; TMA
// zero-fills the columns past D and the rows past Tq or Tk. Keys past Tk (zero
// rows of a padded k) are masked by count, never summed; query rows past Tq are
// not written. One producer thread (warpgroup 2, registers lowered with
// setmaxnreg) loads Q once and streams K and V tiles of 32 keys with TMA into
// STAGES-deep K and V rings, each stage with a full and an empty mbarrier that
// both consumer warpgroups (0 and 1) arrive on. Per tile a consumer computes
// S = Q K^T with wgmma m64n32k16 (Q and K K-major, 128-byte swizzle), runs the
// online softmax in registers (fp32 running max and sum, the 1/sqrt(D) scale on
// the fp32 scores, keys past Tk masked to -inf), rounds P to bf16 in registers,
// where the score accumulator layout already is wgmma's register-A layout, and
// adds P V with wgmma m64nNk16 against V read MN-major (transposed-B form). Two
// ways to split a block between its consumers, by DP:
// - DP <= 128 (row split): a block owns 128 query rows, each consumer
//   warpgroup 64 of them with the whole head dim: its O accumulator holds DP/2
//   fp32 registers a thread. The warpgroups share each K and V tile but never
//   wait on each other.
// - DP = 256, 512 (depth split): a block owns 64 query rows and splits the
//   head dim, warpgroup g holding O's columns [g*DP/2, (g+1)*DP/2) (64 or 128
//   registers a thread; a whole head of 256 would spill). Each warpgroup runs
//   S over its own half of the depth, writes its fp32 partial to its half of a
//   16 KB exchange buffer, and after a named barrier adds the other's partial;
//   fp32 addition commutes, so both hold the same S bit for bit and run the
//   same softmax.
// S runs over the 16-column steps that hold D, P V over all DP columns: D = 40,
// 80, 160 run at DP = 64, 128, 256, where P V does 1.6x the useful MMA work and
// S 1.2x, 1.0x, 1.0x.
// At DP=512 the shared memory holds Q 64 KB, K 2 x 32 KB, V 2 x 32 KB and the
// exchange 16 KB (ops/attention.flash_smem_bytes mirrors every DP).
// What holds it back now: ptxas allocates the consumers within ~168 registers
// (SASS tops out at R165) although setmaxnreg gives them 240, so at 128 O
// registers (DP = 512) it places S on O's first registers, spills around
// the S product and serializes every wgmma (warning C7512, one wait per
// instruction); in the depth split the two warpgroups move in lockstep through
// the exchange, so the tensor cores idle while both run the softmax; and each
// block streams all of K and V (8 MB per head at T=4096, D=512) from L2 for its
// 64 or 128 query rows.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;        // query rows per consumer warpgroup
constexpr int BKV = 32;       // keys per tile
constexpr int THREADS = 384;  // warpgroups 0, 1: consumers; warpgroup 2: producer
constexpr int Q_CHUNK = BQ * 64 * 2;    // one [64 rows x 64 columns] bf16 TMA box
constexpr int KV_CHUNK = BKV * 64 * 2;  // one [32 keys x 64 columns] bf16 TMA box
constexpr int X_BYTES = 2 * BQ * BKV * 4;

// the row split (each consumer warpgroup 64 query rows, the whole head dim) up
// to DP = 128; the depth split above, where a whole head's O would spill
__host__ __device__ constexpr bool split_rows(int DP) { return DP <= 128; }
// K and V tiles in flight: small tiles go by faster than a TMA load's latency
__host__ __device__ constexpr int stages(int DP) { return DP <= 128 ? 4 : 2; }

__host__ __device__ constexpr int smem_bytes(int DP) {
  // Q (64 rows per consumer warpgroup in the row split), the K and V rings, the
  // depth split's exchange, 1 + 4 * stages mbarriers, alignment slack
  return (split_rows(DP) ? 2 : 1) * (DP / 64) * Q_CHUNK + 2 * stages(DP) * (DP / 64) * KV_CHUNK +
         (split_rows(DP) ? 0 : X_BYTES) + (1 + 4 * stages(DP)) * 8 + 1024;
}

template <int NH>
__device__ __forceinline__ void wgmma_pv(float (&o)[NH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NH == 256) wgmma_rs_n256<1>(o, a, db, 1);
  else if constexpr (NH == 128) wgmma_rs_n128<1>(o, a, db, 1);
  else wgmma_rs_n64<1>(o, a, db, 1);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(__grid_constant__ const CUtensorMap map_q,
                       __grid_constant__ const CUtensorMap map_k,
                       __grid_constant__ const CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ out, int Tq, int Tk, int D, int Tqm,
                       int Dm, float scale_log2) {
  constexpr bool ROW_SPLIT = split_rows(DP);
  constexpr int ROWS = ROW_SPLIT ? 2 : 1;   // 64-row query tiles of a block
  constexpr int STAGES = stages(DP);
  constexpr int QCH = DP / 64;              // 64-column chunks of a tile
  constexpr int NH = ROW_SPLIT ? DP : DP / 2;  // O columns per consumer warpgroup
  constexpr int WCH = NH / 64;
  constexpr int Q_TILE = ROWS * QCH * Q_CHUNK;
  constexpr int KV_TILE = QCH * KV_CHUNK;
  constexpr int XB = ROW_SPLIT ? 0 : X_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;                              // query tile h at + h * QCH * Q_CHUNK
  unsigned char* Ks = smem + Q_TILE;                     // stage s at + s * KV_TILE
  unsigned char* Vs = smem + Q_TILE + STAGES * KV_TILE;  // stage s at + s * KV_TILE
  float* X = reinterpret_cast<float*>(smem + Q_TILE + 2 * STAGES * KV_TILE);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + Q_TILE + 2 * STAGES * KV_TILE + XB);
  uint64_t *kfull = qfull + 1, *kempty = kfull + STAGES, *vfull = kempty + STAGES,
           *vempty = vfull + STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * (BQ * ROWS);
  const int bh = blockIdx.y;
  const int ntiles = (Tk + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 2);  // one arrival per consumer warpgroup
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index through a shuffle, so the compiler knows it is
  // warp-uniform and builds the wgmma descriptors with uniform instructions
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (tid == 256) {
      prefetch_tensormap(&map_q);
      prefetch_tensormap(&map_k);
      prefetch_tensormap(&map_v);
      mbar_arrive_expect_tx(qfull, Q_TILE);
      for (int h = 0; h < ROWS; ++h)
        for (int c = 0; c < QCH; ++c)
          tma_load_3d(Qs + (h * QCH + c) * Q_CHUNK, &map_q, qfull, c * 64, q0 + h * BQ, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        const uint32_t phase = (j / STAGES) & 1;
        mbar_wait(&kempty[st], phase ^ 1);
        mbar_arrive_expect_tx(&kfull[st], KV_TILE);
        for (int c = 0; c < QCH; ++c)
          tma_load_3d(Ks + st * KV_TILE + c * KV_CHUNK, &map_k, &kfull[st], c * 64, j * BKV, bh);
        mbar_wait(&vempty[st], phase ^ 1);
        mbar_arrive_expect_tx(&vfull[st], KV_TILE);
        for (int c = 0; c < QCH; ++c)
          tma_load_3d(Vs + st * KV_TILE + c * KV_CHUNK, &map_v, &vfull[st], c * 64, j * BKV, bh);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    const int g = wg;
    const int lt = tid & 127;
    const int lane = lt & 31;
    // accumulator layout of m64nNk16: d[4j + 2h + e] is row 16*warp + lane/4 + 8h,
    // column 8j + 2*(lane%4) + e
    float o[NH / 2];
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) o[i] = 0.0f;
    float s[BKV / 2];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float* mine = X + g * (BQ * BKV);
    const float* other = X + (1 - g) * (BQ * BKV);

    // the row split reads its own query tile; the depth split's both read the one
    const uint32_t q_addr = smem_u32(Qs) + (ROW_SPLIT ? g * QCH * Q_CHUNK : 0);
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    mbar_wait(qfull, 0);
#pragma unroll 1
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES;
      const uint32_t phase = (j / STAGES) & 1;
      mbar_wait(&kfull[st], phase);
      fence_regs(s);
      wgmma_fence();
      if constexpr (ROW_SPLIT) {
        // S = Q K^T over the 16-column steps that hold D (the rest are zeros)
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks)
          if (ks * 16 < D)
            wgmma_ss_n32<0>(s, make_desc(q_addr + (ks / 4) * Q_CHUNK + (ks % 4) * 32, 16, 1024),
                            make_desc(k_addr + st * KV_TILE + (ks / 4) * KV_CHUNK + (ks % 4) * 32,
                                      16, 1024),
                            ks > 0 ? 1 : 0);
      } else {
        // S_g = Q[:, half g] K[:, half g]^T; below DP = 512 over the 16-column
        // steps of the half that hold D (D > DP/2 there, so each half has one)
#pragma unroll
        for (int c = 0; c < WCH; ++c)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int col = g * WCH + c;
            if (DP == 512 || col * 64 + k * 16 < D)
              wgmma_ss_n32<0>(s, make_desc(q_addr + col * Q_CHUNK + k * 32, 16, 1024),
                              make_desc(k_addr + st * KV_TILE + col * KV_CHUNK + k * 32, 16,
                                        1024),
                              (c > 0 || k > 0) ? 1 : 0);
          }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (lt == 0) mbar_arrive(&kempty[st]);

      if constexpr (!ROW_SPLIT) {
        // S = S_0 + S_1 through the exchange buffer
        named_barrier(1, 256);  // the other warpgroup has read this buffer's last tile
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) mine[i * 128 + lt] = s[i];
        named_barrier(2, 256);
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] += other[i * 128 + lt];
      }

      // keys past Tk only in the last tile: mask there, against one register
      if (j == ntiles - 1) {
        // column 8jj + 2*(lane%4) + e of the tile is past Tk when 8jj + e >= left
        const int left = Tk - j * BKV - 2 * (lane & 3);
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (8 * jj + e >= left) s[4 * jj + 2 * hh + e] = -INFINITY;
      }
      // online softmax over this thread's two rows
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[4 * jj + 2 * hh + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        alpha[hh] = exp2f((m[hh] - m_new) * scale_log2);
        m[hh] = m_new;
        const float ms = m_new * scale_log2;
        float sum = 0.0f;
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = s[4 * jj + 2 * hh + e];
            v = exp2f(fmaf(v, scale_log2, -ms));
            sum += v;
          }
        l[hh] = l[hh] * alpha[hh] + sum;
      }
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          o[4 * jj + 2 * hh] *= alpha[hh];
          o[4 * jj + 2 * hh + 1] *= alpha[hh];
        }
      // P as bf16 in wgmma's register-A layout, 16 keys per k step
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O_g += P V[:, the warpgroup's columns]
      mbar_wait(&vfull[st], phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_pv<NH>(o, pa[kk],
                     make_desc(v_addr + st * KV_TILE + (ROW_SPLIT ? 0 : g * WCH * KV_CHUNK) +
                                   kk * 16 * 128,
                               KV_CHUNK, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lt == 0) mbar_arrive(&vempty[st]);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + (ROW_SPLIT ? g * BQ : 0) + (lt >> 5) * 16 + (lane >> 2) + 8 * hh;
      if (row >= Tq) continue;
      const float inv = 1.0f / l[hh];
      __nv_bfloat16* dst = out + ((size_t)bh * Tqm + row) * Dm;
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj) {
        const int col = (ROW_SPLIT ? 0 : g * NH) + 8 * jj + 2 * (lane & 3);
        if (col < D)
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16x2(o[4 * jj + 2 * hh] * inv, o[4 * jj + 2 * hh + 1] * inv);
      }
    }
  }
}

template <int DP>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           __nv_bfloat16* out, int BH, int Tq, int Tk, int D, int Tqm, int Dm,
           cudaStream_t stream) {
  static std::atomic<uint64_t> smem_ready{0};
  const int rc = allow_dynamic_smem(flash_attention_kernel<DP>, smem_bytes(DP), smem_ready);
  if (rc != 0) return rc;
  const int rows = BQ * (split_rows(DP) ? 2 : 1);
  dim3 grid((unsigned)((Tq + rows - 1) / rows), (unsigned)BH);
  flash_attention_kernel<DP><<<grid, THREADS, smem_bytes(DP), stream>>>(
      mq, mk, mv, out, Tq, Tk, D, Tqm, Dm, 1.4426950408889634f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [BH, Tqm, Dm] and k, v: [BH, Tkm, Dm] bf16 contiguous, of which rows < Tq
// (q, out) or < Tk (k, v) and columns < D hold the problem (D % 8 == 0, D <= 512,
// Tq, Tk >= 1); Tqm, Tkm, Dm >= 64 so that every TMA box fits inside its tensor,
// and the padding is zero. smem is the caller's copy of the shared-memory layout
// (ops/attention.flash_smem_bytes); a mismatch is refused. Returns a cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int BH, int Tq, int Tk, int D, int Tqm, int Tkm, int Dm,
                                    int smem, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 512 || Tq <= 0 || Tk <= 0 || Tqm < 64 || Tqm < Tq ||
      Tkm < 64 || Tkm < Tk || Dm < 64 || Dm < D || Dm % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int DP = Dm <= 64 ? 64 : Dm <= 128 ? 128 : Dm <= 256 ? 256 : 512;
  if (Dm > 512 || smem != smem_bytes(DP)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t rows = (uint64_t)(i == 0 ? Tqm : Tkm);
    const uint64_t dims[3] = {(uint64_t)Dm, rows, (uint64_t)BH};
    const uint64_t strides[2] = {(uint64_t)Dm * 2, rows * Dm * 2};
    const uint64_t box[3] = {64, (uint64_t)(i == 0 ? BQ : BKV), 1};
    const int rc = encode_bf16_map(&maps[i], ptrs[i], 3, dims, strides, box);
    if (rc != 0) return rc;
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (DP == 64) return launch<64>(maps[0], maps[1], maps[2], o, BH, Tq, Tk, D, Tqm, Dm, st);
  if (DP == 128) return launch<128>(maps[0], maps[1], maps[2], o, BH, Tq, Tk, D, Tqm, Dm, st);
  if (DP == 256) return launch<256>(maps[0], maps[1], maps[2], o, BH, Tq, Tk, D, Tqm, Dm, st);
  return launch<512>(maps[0], maps[1], maps[2], o, BH, Tq, Tk, D, Tqm, Dm, st);
}
