// K1's backward: the gradient of GroupNorm with fp32 statistics, affine, optional
// FiLM and SiLU (csrc/group_norm.cu) with respect to x, the affine weight and bias
// and the FiLM scale and shift, NCHW; bf16, fp16 or fp32 in and out.
//
// Replaces the recompute through XLA of the Pallas kernel's custom_vjp
// (bbdm_tpu/ops/group_norm_pallas.py:177-216), which the port used to mirror by
// re-running the plain twin under autograd. Per (n, group) span, from the saved x
// and the incoming dy, in fp32:
//
//   xhat = (x - mean) * rstd,  z = (w xhat + b) (1 + fs) + fb
//   dz = dy * sigmoid(z) (1 + z (1 - sigmoid(z)))  with SiLU, else dy
//   per channel c over the span's hw:  S1_c = sum dz,  S2_c = sum dz xhat
//   d fb = S1,  d fs = w S2 + b S1,  d w = sum_n (1 + fs) S2,  d b = sum_n (1 + fs) S1
//   g_c = w (1 + fs),  m1 = mean_c(g S1) / hw,  m2 = mean_c(g S2) / hw
//   dx = rstd (g dz - m1 - xhat m2)
//
// What bounds it on the H100: memory. It reads x and dy and writes dx (6 bytes an
// element in bf16) at about 30 flops and 4 MUFU operations an element (two
// sigmoids with SiLU), below both the card's arithmetic and its special-function
// rate at the bandwidth. The span must be read three times (statistics, the
// per-channel sums, dx), so it lives on chip.
//
// Design: one thread block cluster of cs CTAs (cs = 1, 2, 4, 8) per span, each CTA
// holding its contiguous slice of x and of dy in shared memory (16-byte vector
// loads); what does not fit is read again from device memory in each pass.
// - Statistics: each CTA's fp32 sum and sum of squares, exchanged after a cluster
//   barrier through distributed shared memory in rank order (the mean and rstd the
//   forward computes, recomputed rather than saved).
// - Per-channel sums: each warp walks a contiguous region of the slice, 32
//   vectors at a time; a segmented scan over the lanes (the vectors of one channel
//   are neighbours) gives each channel's part of the 32, added by one lane into the
//   warp's own entry for that channel. The entries are summed per channel in warp
//   order, then the cs CTAs' partials in rank order through distributed shared
//   memory: no atomics, so two calls give the same bits.
// - dx: one more pass over the held slice, written as 16-byte stores; the CTA of
//   rank c % cs writes channel c's FiLM gradients and its [N, C] fp32 partials of
//   the weight and bias gradients, which a second small launch sums over n in
//   order.
// Where hw is not a multiple of a 16-byte vector, the same kernel runs with one
// element a vector, so that no vector spans two channels.
// ops/group_norm.plan_group_norm_bwd decides the cluster size, slice and shared
// memory; the entry launches exactly its values and refuses others.
#include <cuda_fp16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int FOLD_THREADS = 256;
constexpr int MAX_DYN_SMEM = 232448 - 1024;  // the rest holds the static arrays below

struct BwdArgs {
  int cs, groups, cpg, hw, span, per, keep, d_off, f_off;
  int film, film_f32, silu;
  long long film_stride;
  float eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// A 16-byte vector of T as floats and back (element 2i of a 16-bit pair is its low half)
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  __device__ static void unpack(uint4 v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  __device__ static void unpack(uint4 v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = pack_bf16x2(f[2 * i], f[2 * i + 1]);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec16<__half> {
  __device__ static void unpack(uint4 v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 p = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The kernel's unit of access: a 16-byte vector (WIDE) or one element.
template <typename T, bool WIDE>
struct Pack {
  static constexpr int N = WIDE ? 16 / (int)sizeof(T) : 1;
  using R = typename std::conditional<WIDE, uint4, T>::type;
  __device__ static R load(const T* p) { return *reinterpret_cast<const R*>(p); }
  __device__ static void store(T* p, R r) { *reinterpret_cast<R*>(p) = r; }
  __device__ static void unpack(R r, float (&f)[N]) {
    if constexpr (WIDE) Vec16<T>::unpack(r, f);
    else f[0] = to_f(r);
  }
  __device__ static R pack(const float (&f)[N]) {
    if constexpr (WIDE) return Vec16<T>::pack(f);
    else return from_f<T>(f[0]);
  }
};

// sigmoid(z) with the forward's flush-to-zero MUFU forms: exp2 and reciprocal
__device__ __forceinline__ float sigmoid(float z) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.4426950408889634f * z));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ w, const float* __restrict__ b,
                      const void* __restrict__ fs, const void* __restrict__ fb,
                      T* __restrict__ dx, void* __restrict__ dfs, void* __restrict__ dfb,
                      float* __restrict__ pw, float* __restrict__ pb, const BwdArgs a) {
  using P = Pack<T, WIDE>;
  constexpr int V = P::N;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][WARPS];
  __shared__ float pst[2];  // this CTA's sum and sum of squares, read by the cluster
  __shared__ float stat[4];  // mean, rstd, m1, m2
  T* xs = reinterpret_cast<T*>(smem);  // xs[i], dys[i]: the slice's element i
  T* dys = reinterpret_cast<T*>(smem + a.d_off);
  float* gsc = reinterpret_cast<float*>(smem + a.f_off);  // w (1 + fs) per channel
  float* gsh = gsc + a.cpg;                                // b (1 + fs) + fb
  float* part = gsh + a.cpg;  // [cpg][2] this CTA's S1, S2, read by the cluster
  float* tot = part + 2 * a.cpg;  // [cpg][2] the span's S1, S2
  float* ent = tot + 2 * a.cpg;   // [cpg + WARPS][2] warp w's sums of channel c at c + w

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_ctarank();
  const int ng = blockIdx.x / a.cs, n = ng / a.groups, g = ng % a.groups;
  const int C = a.groups * a.cpg;
  const int start = rank * a.per;  // this CTA's slice of the span
  const int len = max(0, min(a.per, a.span - start));
  const int keep = min(len, a.keep);  // the part held in shared memory
  const int nvec = len / V;
  const long long base = (long long)ng * a.span + start;
  const T* xg = x + base;
  const T* dyg = dy + base;

  // affine and FiLM per channel of the group (every CTA needs all of them for m1, m2)
  for (int c = tid; c < a.cpg; c += THREADS) {
    const int ch = g * a.cpg + c;
    float s = w[ch], t = b[ch];
    if (a.film) {
      const long long i = (long long)n * a.film_stride + ch;
      const float f1 = 1.f + (a.film_f32 ? static_cast<const float*>(fs)[i]
                                         : to_f(static_cast<const T*>(fs)[i]));
      const float f2 = a.film_f32 ? static_cast<const float*>(fb)[i]
                                  : to_f(static_cast<const T*>(fb)[i]);
      s *= f1;
      t = fmaf(t, f1, f2);
    }
    gsc[c] = s;
    gsh[c] = t;
  }

  // ------------------------------------------------------- load + statistics
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int v = tid; v < nvec; v += THREADS) {
    const int i = v * V;
    const typename P::R xv = P::load(xg + i);
    if (i < keep) {
      P::store(xs + i, xv);
      P::store(dys + i, P::load(dyg + i));
    }
    float f[V];
    P::unpack(xv, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1 += f[j];
      s2 = fmaf(f[j], f[j], s2);
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = warp_sum(lane < WARPS ? red[0][lane] : 0.f);
    s2 = warp_sum(lane < WARPS ? red[1][lane] : 0.f);
    if (lane == 0) {
      pst[0] = s1;
      pst[1] = s2;
    }
  }
  cluster_arrive();  // every CTA's pst is written
  cluster_wait();
  if (tid == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < a.cs; ++r) {
      t1 += ld_cluster_f32(&pst[0], r);
      t2 += ld_cluster_f32(&pst[1], r);
    }
    const float mean = t1 / (float)a.span;
    const float var = t2 / (float)a.span - mean * mean;
    stat[0] = mean;
    stat[1] = rsqrtf(var + a.eps);
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];

  // x and dz of the slice's vector v, as floats; returns xhat in xf and dz in df,
  // with the vector's channel (relative to the group) in c
  const auto grad_z = [&](int v, float (&xf)[V], float (&df)[V], int& c) {
    const int i = v * V;
    if (i < keep) {
      P::unpack(P::load(xs + i), xf);
      P::unpack(P::load(dys + i), df);
    } else {
      P::unpack(P::load(xg + i), xf);
      P::unpack(P::load(dyg + i), df);
    }
    c = (start + i) / a.hw;
    const float s = gsc[c] * rstd, t = fmaf(-mean, s, gsh[c]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (a.silu) {
        const float z = fmaf(xf[j], s, t), sg = sigmoid(z);
        df[j] *= sg * fmaf(z, 1.f - sg, 1.f);
      }
      xf[j] = (xf[j] - mean) * rstd;
    }
  };

  // ---------------------------------------------------------- per-channel sums
  const int rv = (nvec + WARPS - 1) / WARPS;  // vectors of each warp's region
  const int v_lo = warp * rv, v_hi = min(nvec, v_lo + rv);
  if (v_lo < v_hi) {
    const int cw_lo = (start + v_lo * V) / a.hw, cw_hi = (start + v_hi * V - 1) / a.hw;
    for (int c = cw_lo + lane; c <= cw_hi; c += 32) {
      ent[2 * (c + warp)] = 0.f;
      ent[2 * (c + warp) + 1] = 0.f;
    }
    __syncwarp();
    for (int v0 = v_lo; v0 < v_hi; v0 += 32) {
      const int v = v0 + lane;
      float t1 = 0.f, t2 = 0.f;
      int c = 0, off = 0;
      const bool live = v < v_hi;
      if (live) {
        float xf[V], df[V];
        grad_z(v, xf, df, c);
        off = (start + v * V - c * a.hw) / V;  // vectors since the channel's start
#pragma unroll
        for (int j = 0; j < V; ++j) {
          t1 += df[j];
          t2 = fmaf(df[j], xf[j], t2);
        }
      }
      // segmented inclusive scan: lane - d belongs to this lane's channel iff off >= d
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float u1 = __shfl_up_sync(0xffffffffu, t1, d);
        const float u2 = __shfl_up_sync(0xffffffffu, t2, d);
        if (lane >= d && off >= d) {
          t1 += u1;
          t2 += u2;
        }
      }
      const bool last = live && (lane == 31 || v + 1 == v_hi || (off + 1) * V == a.hw);
      if (last) {
        ent[2 * (c + warp)] += t1;
        ent[2 * (c + warp) + 1] += t2;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // this CTA's partial of each channel: its warps' entries in warp order
  for (int c = tid; c < a.cpg; c += THREADS) {
    float p1 = 0.f, p2 = 0.f;
    const int lo = max(c * a.hw, start) - start, hi = min((c + 1) * a.hw, start + len) - start;
    if (lo < hi) {
      for (int wp = lo / V / rv; wp <= (hi / V - 1) / rv; ++wp) {
        p1 += ent[2 * (c + wp)];
        p2 += ent[2 * (c + wp) + 1];
      }
    }
    part[2 * c] = p1;
    part[2 * c + 1] = p2;
  }
  cluster_arrive();  // every CTA's part is written (and pst read)
  cluster_wait();
  for (int c = tid; c < a.cpg; c += THREADS) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < a.cs; ++r) {
      t1 += ld_cluster_f32(&part[2 * c], r);
      t2 += ld_cluster_f32(&part[2 * c + 1], r);
    }
    tot[2 * c] = t1;
    tot[2 * c + 1] = t2;
  }
  // no CTA leaves while a peer may still read its part: the wait is at the end
  cluster_arrive();
  __syncthreads();

  // the per-(n, c) gradients of the channels this rank writes
  for (int c = rank + a.cs * tid; c < a.cpg; c += a.cs * THREADS) {
    const int ch = g * a.cpg + c;
    const long long o = (long long)n * C + ch;
    const float t1 = tot[2 * c], t2 = tot[2 * c + 1];
    if (dfs != nullptr) {
      const float d = fmaf(w[ch], t2, b[ch] * t1);
      if (a.film_f32) static_cast<float*>(dfs)[o] = d;
      else static_cast<T*>(dfs)[o] = from_f<T>(d);
    }
    if (dfb != nullptr) {
      if (a.film_f32) static_cast<float*>(dfb)[o] = t1;
      else static_cast<T*>(dfb)[o] = from_f<T>(t1);
    }
    if (pw != nullptr) {
      float f1 = 1.f;
      if (a.film) {
        const long long i = (long long)n * a.film_stride + ch;
        f1 += a.film_f32 ? static_cast<const float*>(fs)[i] : to_f(static_cast<const T*>(fs)[i]);
      }
      pw[o] = f1 * t2;
      pb[o] = f1 * t1;
    }
  }

  if (dx != nullptr) {
    if (warp == 0) {
      float m1 = 0.f, m2 = 0.f;
      for (int c = lane; c < a.cpg; c += 32) {
        m1 = fmaf(gsc[c], tot[2 * c], m1);
        m2 = fmaf(gsc[c], tot[2 * c + 1], m2);
      }
      m1 = warp_sum(m1);
      m2 = warp_sum(m2);
      if (lane == 0) {
        stat[2] = m1 / (float)a.span;
        stat[3] = m2 / (float)a.span;
      }
    }
    __syncthreads();
    const float m1 = stat[2], m2 = stat[3];
    // ------------------------------------------------------------------- dx
#pragma unroll 2
    for (int v = tid; v < nvec; v += THREADS) {
      float xf[V], df[V];
      int c;
      grad_z(v, xf, df, c);
      const float gc = gsc[c];
#pragma unroll
      for (int j = 0; j < V; ++j) df[j] = rstd * fmaf(gc, df[j], -fmaf(xf[j], m2, m1));
      P::store(dx + base + v * V, P::pack(df));
    }
  }
  cluster_wait();
}

// d w[c] = sum_n pw[n, c], d b[c] = sum_n pb[n, c], in order of n
__global__ void __launch_bounds__(FOLD_THREADS)
group_norm_bwd_fold_kernel(const float* __restrict__ pw, const float* __restrict__ pb,
                           float* __restrict__ dw, float* __restrict__ db, int N, int C) {
  const int c = blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (c >= C) return;
  float sw = 0.f, sb = 0.f;
  for (int n = 0; n < N; ++n) {
    sw += pw[(long long)n * C + c];
    sb += pb[(long long)n * C + c];
  }
  if (dw != nullptr) dw[c] = sw;
  if (db != nullptr) db[c] = sb;
}

// Once per kernel and device: the dynamic shared-memory limit, and the largest
// shared carveout so that two CTAs of up to ~113 KB fit on one SM.
template <typename T, bool WIDE>
int prepare() {
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = 1ull << (dev & 63);
  if (ready.load(std::memory_order_acquire) & bit) return 0;
  err = cudaFuncSetAttribute(group_norm_bwd_kernel<T, WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(group_norm_bwd_kernel<T, WIDE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  ready.fetch_or(bit, std::memory_order_release);
  return 0;
}

// cs 1 runs as a plain launch, which starts sooner (the CTA is its own cluster
// for the cluster instructions)
template <typename T, bool WIDE>
int launch(const void* x, const void* dy, const float* w, const float* b, const void* fs,
           const void* fb, void* dx, void* dfs, void* dfb, float* pw, float* pb,
           const BwdArgs& a, unsigned grid, int smem, cudaStream_t stream) {
  int rc = prepare<T, WIDE>();
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs == 1 ? 0 : 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, group_norm_bwd_kernel<T, WIDE>, static_cast<const T*>(x), static_cast<const T*>(dy),
      w, b, fs, fb, static_cast<T*>(dx), dfs, dfb, pw, pb, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: contiguous [N, C, hw] of one type (dtype 0 bf16, 1 fp16, 2 fp32), 16-byte
// aligned; w, b: fp32 [C]; fs, fb: FiLM scale and shift at [n * film_stride + c],
// of x's type or fp32 (film_f32), or null when film is 0. Outputs, each null where
// its gradient is not wanted: dx; dfs, dfb: contiguous [N, C] of the FiLM type;
// part: fp32 [2, N, C] scratch for the weight and bias partials, with dw, db: fp32
// [C] (part is null iff both are). `plan` holds the 14 values of
// ops/group_norm.GroupNormBwdPlan.c_values, launched as they are. Launches the
// kernel and, where part is given, the fold over n. Returns a cudaError_t
// (cudaErrorInvalidValue for a plan this kernel was not compiled for).
extern "C" int group_norm_bwd(const void* x, const void* dy, const void* w, const void* b,
                              const void* fs, const void* fb, void* dx, void* dfs, void* dfb,
                              void* part, void* dw, void* db, const uint64_t* plan, int dtype,
                              int film, int film_f32, long long film_stride, int silu,
                              float eps, void* stream) {
  const uint64_t grid = plan[0], cs = plan[1], threads = plan[2], smem_bytes = plan[3],
                 d_off = plan[4], f_off = plan[5], groups = plan[6], cpg = plan[7],
                 hw = plan[8], span = plan[9], per = plan[10], keep = plan[11], vec = plan[12],
                 itemsize = plan[13];
  if (dtype < 0 || dtype > 2 || itemsize != (dtype == 2 ? 4u : 2u))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t wide = 16 / itemsize;
  const bool ok =
      threads == (uint64_t)THREADS && (cs == 1 || cs == 2 || cs == 4 || cs == 8) &&
      groups > 0 && grid > 0 && grid % (cs * groups) == 0 && grid < (1ull << 31) && hw > 0 &&
      cpg > 0 && span == cpg * hw && span < (1ull << 31) && (vec == wide || vec == 1) &&
      hw % vec == 0 && per % wide == 0 && per * cs >= span && keep > 0 && keep <= per &&
      keep % wide == 0 && d_off == (keep * itemsize + 15) / 16 * 16 && f_off == 2 * d_off &&
      smem_bytes == f_off + 4 * (8 * cpg + 2 * WARPS) && smem_bytes <= (uint64_t)MAX_DYN_SMEM &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
      (film == 0 || (fs != nullptr && fb != nullptr)) &&
      (film != 0 || (dfs == nullptr && dfb == nullptr)) &&
      ((part == nullptr) == (dw == nullptr && db == nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.cs = (int)cs;
  a.groups = (int)groups;
  a.cpg = (int)cpg;
  a.hw = (int)hw;
  a.span = (int)span;
  a.per = (int)per;
  a.keep = (int)keep;
  a.d_off = (int)d_off;
  a.f_off = (int)f_off;
  a.film = film;
  a.film_f32 = film_f32;
  a.silu = silu;
  a.film_stride = film_stride;
  a.eps = eps;
  const int N = (int)(grid / (cs * groups)), C = (int)(groups * cpg);
  float* pw = static_cast<float*>(part);
  float* pb = part != nullptr ? pw + (long long)N * C : nullptr;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const int sm = (int)smem_bytes;
  const unsigned g = (unsigned)grid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto tag, bool wide) {
    using T = decltype(tag);
    return wide ? launch<T, true>(x, dy, wf, bf, fs, fb, dx, dfs, dfb, pw, pb, a, g, sm, st)
                : launch<T, false>(x, dy, wf, bf, fs, fb, dx, dfs, dfb, pw, pb, a, g, sm, st);
  };
  const int rc = dtype == 0   ? run(__nv_bfloat16(), vec != 1)
                 : dtype == 1 ? run(__half(), vec != 1)
                              : run(float(), vec != 1);
  if (rc != 0 || part == nullptr) return rc;
  group_norm_bwd_fold_kernel<<<(C + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0, st>>>(
      pw, pb, static_cast<float*>(dw), static_cast<float*>(db), N, C);
  return static_cast<int>(cudaGetLastError());
}
