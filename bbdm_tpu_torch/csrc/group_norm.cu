// K1: GroupNorm with fp32 statistics, affine, optional FiLM and SiLU, NCHW; bf16,
// fp16 or fp32 in and out, one launch per call.
//
// Replaces bbdm_tpu/ops/group_norm_pallas.py:group_norm_pallas (the Pallas _kernel:
// a stats phase and an apply phase over (N, 2, tiles), sums carried in VMEM
// scratch, FiLM folded into one scale and shift per channel). Computes
// _group_norm_xla (bbdm_tpu/ops/group_norm.py):
//
//   y = (x - mean) * rstd * w + b [* (1 + fs) + fb] [-> silu],
//   mean, var = E[x], E[x^2] - mean^2 over one (n, group), rstd = rsqrt(var + eps)
//
// What bounds it on the H100: memory. It does about 10 flops per element against
// one read and one write (4 bytes in bf16), some 300x below the rate at which the
// card's arithmetic would bind. The largest call on LBBDM-f4 is the VQGAN
// decoder's [8, 256, 256, 256] bf16 norm: 268 MB in and out, 160 us at 3.35 TB/s.
//
// Design: in NCHW one (n, group) is one contiguous span of C/G * HW elements (up to
// 1 MB in bf16 on the path). The span lives on chip, so x is read from device
// memory once: one thread block cluster of cs CTAs (cs = 1, 2, 4, 8) per span, each
// CTA copying its contiguous slice into shared memory.
// - Load: where the span is 16-byte aligned, one thread issues 1-D bulk copies
//   (cp.async.bulk, completion on one mbarrier per chunk) and all threads sum each
//   chunk in fp32 as it lands; otherwise 16-byte vector loads with scalar edges.
// - Exchange: each CTA's fp32 sum and sum of squares go to its shared memory; after
//   a cluster barrier every CTA reads all cs partials through distributed shared
//   memory in rank order, so all get the same mean and rstd and the result does not
//   depend on timing. No atomics, no scratch tensor, no second launch.
// - Apply: affine and FiLM fold into one fp32 scale and shift per channel of the
//   slice, computed once (their loads issued before the statistics they wait on);
//   each element is then one FMA (+ SiLU) from shared memory, written as 16-byte
//   stores.
// - Overflow: a slice larger than the shared memory a CTA has (fp32 at 256^2 and
//   shapes off the path) keeps what fits and reads the rest twice, in the stats and
//   in the apply pass.
// - Schedule: only as many clusters as the card runs at once, each walking the
//   spans grid-stride. While a CTA applies one span, every chunk slot it has
//   finished refills with the next span's chunk, so the reads of the next span
//   overlap the compute and the writes of this one (one CTA per SM could not
//   overlap them otherwise). The partials are double-buffered by span parity, so
//   one cluster barrier per span suffices; a last one before exit keeps every
//   CTA's shared memory alive while a peer may still read it.
// ops/group_norm.plan_group_norm decides the cluster size, slices, chunks, threads
// and shared memory; the entry launches exactly its values, with as many clusters
// as the card runs at once, and refuses others.
// What holds it back now (PERF.md): a span's reads, statistics, exchange and
// writes follow each other, so a call with one span per CTA (most UNet norms) pays
// the whole chain of latencies once, most at the smallest spans; the SiLU's
// two MUFU operations per element (exp2, reciprocal) bound the apply pass's
// compute; and at 1 MB spans only 15 clusters of 8 fit the card at once.
#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 512;
constexpr int MAX_CHUNKS = 8;
constexpr int MAX_DYN_SMEM = 232448 - 1024;  // the rest holds the static arrays below

struct GnArgs {
  int cs, spans, groups, cpg, hw, span, per, keep, chunk, bulk, sc_off;
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

// A 16-byte vector as 16 / sizeof(T) floats and back; element 2i of a 16-bit pair
// is its low half (bf16 -> fp32 is a shift, exact).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
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
struct Vec<__nv_bfloat16> {
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
struct Vec<__half> {
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

template <typename T>
__device__ __forceinline__ void acc_vec(uint4 v, float& s1, float& s2) {
  float f[16 / sizeof(T)];
  Vec<T>::unpack(v, f);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) {
    s1 += f[j];
    s2 = fmaf(f[j], f[j], s2);
  }
}

// y * sigmoid(y) with the flush-to-zero MUFU forms (two per element, the apply
// pass's limit): exp2 and reciprocal, each within about 2 fp32 ulps
__device__ __forceinline__ float silu(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.4426950408889634f * y));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return y * r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element range [lo, hi) of x in VEC-element vectors aligned to 16 bytes, strided
// over the block: full(e0) for a vector wholly inside, one(e) for each element of
// the vectors cut by lo or hi.
template <int VEC, typename Full, typename One>
__device__ __forceinline__ void for_vectors(long long lo, long long hi, Full full, One one) {
  if (hi <= lo) return;
  const long long a = lo - lo % VEC;
  const long long nv = (hi - a + VEC - 1) / VEC;
  for (long long k = threadIdx.x; k < nv; k += THREADS) {
    const long long e0 = a + k * VEC;
    if (e0 >= lo && e0 + VEC <= hi) {
      full(e0);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (e0 + j >= lo && e0 + j < hi) one(e0 + j);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, const void* __restrict__ fs,
                  const void* __restrict__ fb, T* __restrict__ out, const GnArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[MAX_CHUNKS];
  __shared__ float part[2][2];  // [span parity][sum, sum of squares]
  __shared__ float red[2][THREADS / 32];
  __shared__ float stat[2];
  T* buf = reinterpret_cast<T*>(smem);  // buf[i] holds x[a0 + i]
  float* sc = reinterpret_cast<float*>(smem + a.sc_off);  // w (1 + fs) per channel
  float* sh = sc + a.cpg;                                  // b (1 + fs) + fb

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_ctarank();
  const int cluster = blockIdx.x / a.cs, clusters = gridDim.x / a.cs;
  const int start = rank * a.per;  // this CTA's slice of every span
  const int len = max(0, min(a.per, a.span - start));
  const int keep = min(len, a.keep);  // the part held in shared memory
  const int c_lo = start / a.hw, c_hi = len > 0 ? (start + len - 1) / a.hw : c_lo - 1;
  const int nch = a.bulk ? (keep + a.chunk - 1) / a.chunk : 0;

  // chunk c of span ng into its slot; completion on bars[c]
  const auto issue = [&](int ng, int c) {
    const int c0 = c * a.chunk;
    const uint32_t bytes = (uint32_t)(min(a.chunk, keep - c0) * (int)sizeof(T));
    mbar_arrive_expect_tx(&bars[c], bytes);
    bulk_load(buf + c0, x + (long long)ng * a.span + start + c0, bytes, &bars[c]);
  };
  if (a.bulk) {
    if (tid == 0) {
      for (int c = 0; c < nch; ++c) mbar_init(&bars[c], 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0 && cluster < a.spans)
      for (int c = 0; c < nch; ++c) issue(cluster, c);
  }

  // The cluster walks the spans cluster, cluster + clusters, ...; while it applies
  // one span, each chunk slot it has finished refills with the next span's chunk.
  int it = 0;
  for (int ng = cluster; ng < a.spans; ng += clusters, ++it) {
    const int n = ng / a.groups, g = ng % a.groups;
    const long long base = (long long)ng * a.span, g0 = base + start, a0 = g0 - g0 % VEC;
    const int parity = it & 1;
    __syncthreads();  // the previous span is done with buf (vector path), sc and sh

    // affine and FiLM per channel of the slice, before the statistics they wait on
    for (int c = c_lo + tid; c <= c_hi; c += THREADS) {
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
      sc[c] = s;
      sh[c] = t;
    }

    // ------------------------------------------------------------ load + stats
    float s1 = 0.f, s2 = 0.f;
    if (a.bulk) {
      for (int c = 0; c < nch; ++c) {
        const int c0 = c * a.chunk, nv = min(a.chunk, keep - c0) / VEC;
        mbar_wait(&bars[c], parity);
        for (int v = tid; v < nv; v += THREADS)
          acc_vec<T>(*reinterpret_cast<const uint4*>(buf + c0 + v * VEC), s1, s2);
      }
    } else {
      for_vectors<VEC>(
          g0, g0 + keep,
          [&](long long e0) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + e0));
            *reinterpret_cast<uint4*>(buf + (e0 - a0)) = v;
            acc_vec<T>(v, s1, s2);
          },
          [&](long long e) {
            const T t = x[e];
            buf[e - a0] = t;
            const float f = to_f(t);
            s1 += f;
            s2 = fmaf(f, f, s2);
          });
    }
    // the part of the slice that did not fit: read here and again in the apply pass
    for_vectors<VEC>(
        g0 + keep, g0 + len,
        [&](long long e0) { acc_vec<T>(__ldg(reinterpret_cast<const uint4*>(x + e0)), s1, s2); },
        [&](long long e) {
          const float f = to_f(x[e]);
          s1 += f;
          s2 = fmaf(f, f, s2);
        });

    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
    }
    __syncthreads();
    if (warp == 0) {
      s1 = warp_sum(lane < THREADS / 32 ? red[0][lane] : 0.f);
      s2 = warp_sum(lane < THREADS / 32 ? red[1][lane] : 0.f);
      if (lane == 0) {
        part[parity][0] = s1;
        part[parity][1] = s2;
      }
    }

    // ---------------------------------------------------------------- exchange
    // After this barrier every CTA's partials of this span are written, and every
    // CTA has read the other parity's partials (the span before last), which this
    // span's successor overwrites.
    cluster_arrive();
    cluster_wait();
    if (tid == 0) {
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < a.cs; ++r) {
        t1 += ld_cluster_f32(&part[parity][0], r);
        t2 += ld_cluster_f32(&part[parity][1], r);
      }
      const float mean = t1 / (float)a.span;
      const float var = t2 / (float)a.span - mean * mean;
      stat[0] = mean;
      stat[1] = rsqrtf(var + a.eps);
    }
    __syncthreads();
    const float mean = stat[0], rstd = stat[1];

    // ------------------------------------------------------------------- apply
    const auto act = [&](float y) { return a.silu ? silu(y) : y; };
    const auto apply_vec = [&](long long e0, uint4 v) {
      const int i0 = (int)(e0 - base);
      int c = i0 / a.hw;
      float s = sc[c] * rstd, t = fmaf(-mean, s, sh[c]);
      float f[VEC];
      Vec<T>::unpack(v, f);
      if (i0 - c * a.hw + VEC <= a.hw) {  // the vector lies in one channel
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = act(fmaf(f[j], s, t));
      } else {
        int next = (c + 1) * a.hw;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          while (i0 + j >= next) {  // a channel starts inside the vector
            ++c;
            next += a.hw;
            s = sc[c] * rstd;
            t = fmaf(-mean, s, sh[c]);
          }
          f[j] = act(fmaf(f[j], s, t));
        }
      }
      *reinterpret_cast<uint4*>(out + e0) = Vec<T>::pack(f);
    };
    const auto apply_one = [&](long long e, T v) {
      const int c = (int)(e - base) / a.hw;
      const float s = sc[c] * rstd;
      out[e] = from_f<T>(act(fmaf(to_f(v), s, fmaf(-mean, s, sh[c]))));
    };
    if (a.bulk) {
      const int next = ng + clusters;
      for (int c = 0; c < nch; ++c) {
        const int c0 = c * a.chunk, nv = min(a.chunk, keep - c0) / VEC;
        for (int v = tid; v < nv; v += THREADS)
          apply_vec(g0 + c0 + v * VEC, *reinterpret_cast<const uint4*>(buf + c0 + v * VEC));
        __syncthreads();  // slot c is free
        if (tid == 0 && next < a.spans) issue(next, c);
      }
    } else {
      for_vectors<VEC>(
          g0, g0 + keep,
          [&](long long e0) { apply_vec(e0, *reinterpret_cast<const uint4*>(buf + (e0 - a0))); },
          [&](long long e) { apply_one(e, buf[e - a0]); });
    }
    for_vectors<VEC>(
        g0 + keep, g0 + len,
        [&](long long e0) { apply_vec(e0, __ldg(reinterpret_cast<const uint4*>(x + e0))); },
        [&](long long e) { apply_one(e, x[e]); });
  }

  // no CTA leaves while a peer may still read its partials
  cluster_arrive();
  cluster_wait();
}

// Once per kernel and device: the dynamic shared-memory limit, and the largest
// shared carveout so that two CTAs of up to ~113 KB fit on one SM.
template <typename T>
int prepare() {
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = 1ull << (dev & 63);
  if (ready.load(std::memory_order_acquire) & bit) return 0;
  err = cudaFuncSetAttribute(group_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_DYN_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(group_norm_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  ready.fetch_or(bit, std::memory_order_release);
  return 0;
}

// `launch`: cs 1 runs as a plain launch, which starts sooner (the CTA is its own
// cluster for the cluster instructions); the occupancy query needs the attribute.
cudaLaunchConfig_t config(cudaLaunchAttribute* attr, unsigned grid, int cs, int smem,
                          cudaStream_t stream, bool launch) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = launch && cs == 1 ? 0 : 1;
  return cfg;
}

template <typename T>
int launch(const void* x, const float* w, const float* b, const void* fs, const void* fb,
           void* out, const GnArgs& a, unsigned grid, int smem, cudaStream_t stream) {
  int rc = prepare<T>();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, grid, a.cs, smem, stream, true);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, group_norm_kernel<T>, static_cast<const T*>(x),
                                             w, b, fs, fb, static_cast<T*>(out), a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resident(int cs, int smem, int* clusters) {
  int rc = prepare<T>();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, (unsigned)cs, cs, smem, 0, false);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, group_norm_kernel<T>, &cfg));
}

}  // namespace

// The clusters of `cs` CTAs with `smem_bytes` of dynamic shared memory each that
// the current device runs at once (dtype as for group_norm_fwd).
extern "C" int group_norm_resident_clusters(int dtype, int cs, int smem_bytes, int* clusters) {
  if (dtype == 0) return resident<__nv_bfloat16>(cs, smem_bytes, clusters);
  if (dtype == 1) return resident<__half>(cs, smem_bytes, clusters);
  if (dtype == 2) return resident<float>(cs, smem_bytes, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, out: contiguous [N, C, hw] of one type (dtype 0 bf16, 1 fp16, 2 fp32), 16-byte
// aligned; w, b: fp32 [C]; fs, fb: FiLM scale and shift at [n * film_stride + c],
// of x's type or fp32 (film_f32), or null when film is 0. `plan` holds the 15
// values of ops/group_norm.GroupNormPlan.c_values, launched as they are, except
// that the grid is `clusters` clusters (at most grid / cs, the spans; as many as
// group_norm_resident_clusters says run at once), each walking the spans
// grid-stride. Returns a cudaError_t (cudaErrorInvalidValue for a plan this
// kernel was not compiled for).
extern "C" int group_norm_fwd(const void* x, const void* w, const void* b, const void* fs,
                              const void* fb, void* out, const uint64_t* plan, int clusters,
                              int dtype, int film, int film_f32, long long film_stride, int silu,
                              float eps, void* stream) {
  const uint64_t grid = plan[0], cs = plan[1], threads = plan[2], smem_bytes = plan[3],
                 sc_off = plan[4], groups = plan[5], cpg = plan[6], hw = plan[7],
                 span = plan[8], per = plan[9], keep = plan[10], chunk = plan[11],
                 nchunks = plan[12], bulk = plan[13], itemsize = plan[14];
  if (dtype < 0 || dtype > 2 || itemsize != (dtype == 2 ? 4u : 2u))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t vec = 16 / itemsize;
  const bool ok =
      threads == (uint64_t)THREADS && (cs == 1 || cs == 2 || cs == 4 || cs == 8) &&
      groups > 0 && grid > 0 && grid % (cs * groups) == 0 && grid < (1ull << 31) &&
      clusters > 0 && (uint64_t)clusters <= grid / cs && hw > 0 && cpg > 0 &&
      span == cpg * hw && span < (1ull << 31) && per % vec == 0 && per * cs >= span &&
      keep > 0 && keep <= per && keep % vec == 0 && chunk > 0 && nchunks <= MAX_CHUNKS &&
      chunk * nchunks >= keep && sc_off == ((keep + vec) * itemsize + 15) / 16 * 16 &&
      smem_bytes == sc_off + 8 * cpg && smem_bytes <= (uint64_t)MAX_DYN_SMEM &&
      (bulk == 0 || (span % vec == 0 && chunk % vec == 0)) &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
      (film == 0 || (fs != nullptr && fb != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  GnArgs a;
  a.cs = (int)cs;
  a.spans = (int)(grid / cs);
  a.groups = (int)groups;
  a.cpg = (int)cpg;
  a.hw = (int)hw;
  a.span = (int)span;
  a.per = (int)per;
  a.keep = (int)keep;
  a.chunk = (int)chunk;
  a.bulk = (int)bulk;
  a.sc_off = (int)sc_off;
  a.film = film;
  a.film_f32 = film_f32;
  a.silu = silu;
  a.film_stride = film_stride;
  a.eps = eps;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const unsigned g = (unsigned)(clusters * cs);
  const int sm = (int)smem_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(x, wf, bf, fs, fb, out, a, g, sm, st);
  if (dtype == 1) return launch<__half>(x, wf, bf, fs, fb, out, a, g, sm, st);
  return launch<float>(x, wf, bf, fs, fb, out, a, g, sm, st);
}
