// GroupNorm [+ swish] on NHWC for NVIDIA Hopper (sm_90a), with each sample
// staged once in a thread-block cluster's distributed shared memory.
//
// Replaces both TPU kernels of this function:
//   pnpflow_tpu/ops/pallas_kernels.py:_gn_swish_kernel    (groupnorm_swish)
//   pnpflow_tpu/ops/pallas_kernels.py:_gn_swish_bm_kernel (groupnorm_swish_bm)
// The second differs from the first only in the TPU's batch-minor layout,
// which has no counterpart here.  For sample n and group g of G (CG = C / G
// channels, m = H*W*CG elements):
//
//   mean = sum(x) / m,  var = max(sum(x^2) / m - mean^2, 0)
//   y    = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c]
//   y    = y * sigmoid(y)                                  (swish, optional)
//
// with float32 statistics and the result stored in x's dtype.
//
// Bound on an H100: bytes.  A handful of operations per element, far below
// the ~295 per byte at which compute would be the limit, so the least time
// is one read and one write of x: 2 * N*H*W*C * itemsize / 3.35 TB/s.
//
// Design (path "cluster", every shape whose sample fits in 16 blocks' shared
// memory and whose pixel rows are whole 16-byte vectors):
//  * A sample is split into K contiguous ranges of whole NHWC pixel rows,
//    one per block of a (K, 1, 1) cluster; a range is contiguous bytes.  One
//    thread stages it into shared memory with 1-D bulk async copies (up to
//    MAX_CHUNKS, each on its own mbarrier, so the statistics of the first
//    rows overlap the arrival of the last).
//  * Statistics: a thread owns one 16-byte column of channels (4 fp32 or 8
//    bf16) and sums x and x^2 over its rows in fp32; the partials are folded
//    over lanes, then over warps (or row groups) in a fixed order, then
//    pooled into the G groups, so group sizes 3, 6 and 12 need no masking.
//  * Exchange: after a cluster barrier every block reads the K blocks'
//    (G, 2) partials through distributed shared memory in rank order
//    0..K-1, so all blocks compute the same mean and rstd and results repeat
//    bit for bit.  A second barrier (arrive after the reads, wait before
//    exit) keeps every block's shared memory alive while its peers read it.
//  * Normalize from shared memory in fp32 and store 16-byte vectors in x's
//    dtype.  Device memory sees one read and one write of x: the bound.
//
// Path "two_phase", for samples no cluster holds (the U-Net at 128^2) or
// rows that are not whole 16-byte vectors: launch 1 writes per-(sample, row
// tile) per-channel (sum x, sum x^2) to an (N, T, 2, C) workspace; launch 2
// sums a sample's T partials in order, pools them into groups, normalizes
// and stores.  No atomics; 1.5x the bound's traffic.  V = 1 takes scalar
// loads for rows that are not whole vectors.
//
// The launch plan (path, K or T, threads, shared memory) is chosen by the
// Python wrapper (ops/gn_swish.py:gn_plan); this file checks it.  Plain C
// interface for ctypes; launches go on the caller's stream, allocate nothing
// and the entry returns cudaGetLastError(), -1 for arguments it does not
// take, or -2 when the card cannot hold one cluster of the plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CHUNKS = 4;        // bulk copies (and mbarriers) a block
constexpr int HEAD = 8 * MAX_CHUNKS; // bytes of mbarriers at the front
constexpr int MAX_SMEM = 232448;     // 227 KB, a block's opt-in maximum
constexpr int ERR_CLUSTER = -2;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers, bulk copies and the cluster barrier (PTX, sm_90) --------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// global -> this block's shared memory, completion counted on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// a float at the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ float ld_peer(const float* local, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// ---- shared pieces ------------------------------------------------------
// Rows of the partial-sum buffer: a warp folds its 32 / CV rows by shuffles
// when its lanes hold whole rows; else each row group keeps its own.
__host__ __device__ __forceinline__ int red_rows(int threads, int cv) {
  return (32 % cv == 0 && threads % 32 == 0) ? threads / 32 : threads / cv;
}
__host__ __device__ __forceinline__ size_t tile_offset(int G, int C,
                                                       int rrows) {
  const size_t b = HEAD + 16 * (size_t)G + 8 * (size_t)rrows * C;
  return (b + 127) / 128 * 128;
}

template <typename T, int V>
__device__ __forceinline__ void accumulate(const Vec<T, V>& v, float (&s1)[V],
                                           float (&s2)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float f = to_f(v.v[e]);
    s1[e] += f;
    s2[e] = fmaf(f, f, s2[e]);
  }
}

// Per-channel sums of every thread's (s1, s2), in a fixed order, into
// red[0, C) and red[R*C, R*C + C).  red holds 2 * R * C floats, R =
// red_rows(blockDim.x, C / V).  Ends with the block synchronised.
template <int V>
__device__ void channel_sums(float* red, float (&s1)[V], float (&s2)[V],
                             int C) {
  const int NT = blockDim.x, CV = C / V, tid = threadIdx.x;
  const int R = red_rows(NT, CV);
  int row = tid / CV;
  bool writer = true;
  if (32 % CV == 0 && NT % 32 == 0) {  // R == NT / 32
    for (int off = 16; off >= CV; off >>= 1) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
      }
    }
    row = tid / 32;
    writer = (tid % 32) < CV;
  }
  if (writer) {
    float* r1 = red + (size_t)row * C + (tid % CV) * V;
    float* r2 = r1 + (size_t)R * C;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      r1[e] = s1[e];
      r2[e] = s2[e];
    }
  }
  __syncthreads();
  for (int ch = tid; ch < C; ch += NT) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < R; ++k) {
      a += red[(size_t)k * C + ch];
      b += red[(size_t)(R + k) * C + ch];
    }
    red[ch] = a;
    red[(size_t)R * C + ch] = b;
  }
  __syncthreads();
}

// Pools channel sums (sums at ch[c], squares at ch[stride + c]) into the G
// groups, in channel order: out[g] = sum, out[G + g] = sum of squares.
__device__ void group_sums(const float* ch, size_t stride, int C, int G,
                           float* out) {
  const int CG = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int c = g * CG; c < (g + 1) * CG; ++c) {
      a += ch[c];
      b += ch[stride + c];
    }
    out[g] = a;
    out[G + g] = b;
  }
}

__device__ __forceinline__ void group_stats(float s1, float s2, float m,
                                            float eps, float* mean,
                                            float* rstd) {
  const float mu = s1 / m;
  const float var = fmaxf(s2 / m - mu * mu, 0.f);
  *mean = mu;
  *rstd = rsqrtf(var + eps);
}

// y * sigmoid(y), with approximate exp and division in fp32 (a few ulp);
// in bf16, whose rounding (2^-9 relative) hides a coarser approximation,
// one hardware tanh: sigmoid(y) = 0.5 + 0.5 * tanh(y / 2).  The swish is
// much of a block's arithmetic, and the arithmetic delays its stores.
template <typename T>
__device__ __forceinline__ float swish_f(float f) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    float t;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(0.5f * f));
    return f * fmaf(0.5f, t, 0.5f);
  }
  return __fdividef(f, 1.f + __expf(-f));  // 0 where exp overflows
}

// Normalizes rows [first, end) (stepping by `step`) of column j from src to
// dst, each a sample's rows from the same offset; stats holds (G) means
// then (G) rstds.
template <typename T, int V>
__device__ __forceinline__ void normalize_rows(
    const T* src, T* __restrict__ dst, int first, int end, int step, int j,
    int C, int G, const float* stats, const float* __restrict__ scale,
    const float* __restrict__ bias, int swish) {
  const int CG = C / G;
  float mu[V], rs[V], sc[V], bi[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int ch = j * V + e, g = ch / CG;
    mu[e] = stats[g];
    rs[e] = stats[G + g];
    sc[e] = __ldg(scale + ch);
    bi[e] = __ldg(bias + ch);
  }
  for (int r = first; r < end; r += step) {
    const size_t off = (size_t)r * C + j * V;
    const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(src + off);
    Vec<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float f = (to_f(v.v[e]) - mu[e]) * rs[e];
      f = fmaf(f, sc[e], bi[e]);
      if (swish) f = swish_f<T>(f);
      o.v[e] = from_f<T>(f);
    }
    *reinterpret_cast<Vec<T, V>*>(dst + off) = o;
  }
}

// ---- path "cluster" -----------------------------------------------------
// Grid N*K blocks in clusters of (K, 1, 1): block rank k of cluster n owns
// rows [HW*k/K, HW*(k+1)/K) of sample n.  Thread t owns column t % CV of
// rows t / CV, t / CV + RP, ... (RP = threads / CV), so a block's threads
// cover consecutive 16-byte vectors.
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
gn_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int HW,
                  int C, int G, int K, float eps, int swish) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NT = blockDim.x, CV = C / V, RP = NT / CV, tid = threadIdx.x;
  const int j = tid % CV, rp = tid / CV;
  const uint32_t rank = cluster_rank();
  const size_t n = blockIdx.x / K;
  const int r0 = (int)((long long)HW * rank / K);
  const int rows = (int)((long long)HW * (rank + 1) / K) - r0;
  const int nch = rows < MAX_CHUNKS ? rows : MAX_CHUNKS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + HEAD);  // (2, G), this block
  float* stats = part + 2 * G;                          // (2, G) mean, rstd
  float* red = stats + 2 * G;                           // (2, R, C)
  T* tile = reinterpret_cast<T*>(
      smem + tile_offset(G, C, red_rows(NT, CV)));
  const T* src = x + (n * HW + r0) * C;

  if (tid == 0) {
    for (int c = 0; c < nch; ++c) mbar_init(&bar[c], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < nch; ++c) {
      const int a = rows * c / nch, b = rows * (c + 1) / nch;
      const uint32_t bytes = (uint32_t)((size_t)(b - a) * C * sizeof(T));
      mbar_expect_tx(&bar[c], bytes);
      bulk_g2s(tile + (size_t)a * C, src + (size_t)a * C, bytes, &bar[c]);
    }
  }

  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
  int r = rp;
  for (int c = 0; c < nch; ++c) {
    const int end = rows * (c + 1) / nch;
    if (r < end) mbar_wait(&bar[c], 0);
    for (; r < end; r += RP)
      accumulate(*reinterpret_cast<const Vec<T, V>*>(
                     tile + (size_t)r * C + j * V),
                 s1, s2);
  }
  channel_sums<V>(red, s1, s2, C);
  group_sums(red, (size_t)red_rows(NT, CV) * C, C, G, part);

  cluster_arrive();  // this block's partials are written ...
  cluster_wait();    // ... and so are every peer's
  const float m = (float)HW * (float)(C / G);
  for (int g = tid; g < G; g += NT) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < K; ++k) {
      a += ld_peer(part + g, k);
      b += ld_peer(part + G + g, k);
    }
    group_stats(a, b, m, eps, &stats[g], &stats[G + g]);
  }
  cluster_arrive();  // done reading the peers' shared memory
  __syncthreads();
  normalize_rows<T, V>(tile, y + (n * HW + r0) * C, rp, rows, RP, j, C, G,
                       stats, scale, bias, swish);
  cluster_wait();    // no peer reads this block's partials any more
}

// ---- path "two_phase" ---------------------------------------------------
// Grid (T, N): block (t, n) owns rows [HW*t/T, HW*(t+1)/T) of sample n.
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
gn_moments_kernel(const T* __restrict__ x, float* __restrict__ ws, int HW,
                  int C, int Tn) {
  extern __shared__ __align__(16) float red[];
  const int NT = blockDim.x, CV = C / V, RP = NT / CV, tid = threadIdx.x;
  const int t = blockIdx.x;
  const size_t n = blockIdx.y;
  const int r0 = (int)((long long)HW * t / Tn);
  const int r1 = (int)((long long)HW * (t + 1) / Tn);
  const T* src = x + n * HW * C + (tid % CV) * V;
  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
  for (int r = r0 + tid / CV; r < r1; r += RP)
    accumulate(*reinterpret_cast<const Vec<T, V>*>(src + (size_t)r * C), s1,
               s2);
  channel_sums<V>(red, s1, s2, C);
  const size_t R = red_rows(NT, CV);
  float* out = ws + (n * Tn + t) * 2 * C;
  for (int ch = tid; ch < C; ch += NT) {
    out[ch] = red[ch];
    out[C + ch] = red[R * C + ch];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
gn_normalize_kernel(const T* __restrict__ x, const float* __restrict__ ws,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ y,
                    int HW, int C, int G, int Tn, float eps, int swish) {
  extern __shared__ __align__(16) float sm[];  // (2, C) channel sums
  float* pooled = sm + 2 * C;                  // (2, G) group sums
  float* stats = pooled + 2 * G;               // (2, G) mean, rstd
  const int NT = blockDim.x, CV = C / V, tid = threadIdx.x;
  const int t = blockIdx.x;
  const size_t n = blockIdx.y;
  const float* w = ws + n * Tn * 2 * C;
  for (int ch = tid; ch < C; ch += NT) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < Tn; ++k) {
      a += w[(size_t)k * 2 * C + ch];
      b += w[(size_t)k * 2 * C + C + ch];
    }
    sm[ch] = a;
    sm[C + ch] = b;
  }
  __syncthreads();
  group_sums(sm, C, C, G, pooled);
  __syncthreads();
  const float m = (float)HW * (float)(C / G);
  for (int g = tid; g < G; g += NT)
    group_stats(pooled[g], pooled[G + g], m, eps, &stats[g], &stats[G + g]);
  __syncthreads();
  const int r0 = (int)((long long)HW * t / Tn);
  const int r1 = (int)((long long)HW * (t + 1) / Tn);
  normalize_rows<T, V>(x + n * HW * C, y + n * HW * C, r0 + tid / CV, r1,
                       NT / CV, tid % CV, C, G, stats, scale, bias, swish);
}

// ---- launch -------------------------------------------------------------
struct Args {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  float* ws;
  int N, HW, C, G, swish, K, V, threads, smem;
  float eps;
};

// Raises a kernel's dynamic shared-memory limit to the block maximum (and
// allows 16-block clusters) once per device, and for the cluster path asks
// how many clusters of this shape the card holds at once.  Both cached.
cudaError_t prepare(const void* fn, const cudaLaunchConfig_t* cfg,
                    bool cluster, int* fit) {
  static std::mutex mu;
  struct Attr { int dev; const void* fn; };
  struct Fit { int dev; const void* fn; int K, threads, smem, fit; };
  static Attr attrs[64];
  static Fit fits[256];
  static int n_attrs = 0, n_fits = 0;
  std::lock_guard<std::mutex> lock(mu);
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  bool set = false;
  for (int i = 0; i < n_attrs; ++i)
    if (attrs[i].dev == dev && attrs[i].fn == fn) set = true;
  if (!set) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e == cudaSuccess && cluster)
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (n_attrs < 64) attrs[n_attrs++] = {dev, fn};
  }
  *fit = 1;
  if (!cluster) return cudaSuccess;
  const int K = (int)cfg->attrs[0].val.clusterDim.x;
  const int threads = (int)cfg->blockDim.x, smem = (int)cfg->dynamicSmemBytes;
  for (int i = 0; i < n_fits; ++i) {
    const Fit& f = fits[i];
    if (f.dev == dev && f.fn == fn && f.K == K && f.threads == threads &&
        f.smem == smem) {
      *fit = f.fit;
      return cudaSuccess;
    }
  }
  e = cudaOccupancyMaxActiveClusters(fit, fn, cfg);
  if (e != cudaSuccess) return e;
  if (n_fits < 256) fits[n_fits++] = {dev, fn, K, threads, smem, *fit};
  return cudaSuccess;
}

template <typename T, int V>
int launch_cluster(const Args& a, cudaStream_t stream) {
  const int CV = a.C / V;
  const size_t rows = ((size_t)a.HW + a.K - 1) / a.K;
  if (a.K > 16 || (a.K & (a.K - 1)) ||
      (size_t)a.smem < tile_offset(a.G, a.C, red_rows(a.threads, CV)) +
                           rows * a.C * sizeof(T) ||
      (long long)a.N * a.K > 0x7fffffffLL)
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.N * a.K);
  cfg.blockDim = dim3(a.threads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = gn_cluster_kernel<T, V>;
  int fit = 0;
  cudaError_t e = prepare((const void*)kernel, &cfg, true, &fit);
  if (e != cudaSuccess) return (int)e;
  if (fit < 1) return ERR_CLUSTER;
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)a.x, a.scale, a.bias,
                         (T*)a.y, a.HW, a.C, a.G, a.K, a.eps, a.swish);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_two_phase(const Args& a, cudaStream_t stream) {
  const int R = red_rows(a.threads, a.C / V);
  if (a.ws == nullptr || a.N > 65535 ||
      (size_t)a.smem < 8 * (size_t)R * a.C ||
      (size_t)a.smem < 8 * (size_t)a.C + 16 * (size_t)a.G)
    return -1;
  int fit;
  auto moments = gn_moments_kernel<T, V>;
  auto normalize = gn_normalize_kernel<T, V>;
  cudaError_t e = prepare((const void*)moments, nullptr, false, &fit);
  if (e == cudaSuccess)
    e = prepare((const void*)normalize, nullptr, false, &fit);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.K, a.N);
  moments<<<grid, a.threads, a.smem, stream>>>((const T*)a.x, a.ws, a.HW,
                                               a.C, a.K);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  normalize<<<grid, a.threads, a.smem, stream>>>(
      (const T*)a.x, a.ws, a.scale, a.bias, (T*)a.y, a.HW, a.C, a.G, a.K,
      a.eps, a.swish);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int path, const Args& a, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  if (a.V == VV) {
    if ((uintptr_t)a.x % 16 || (uintptr_t)a.y % 16) return -1;
    return path == 0 ? launch_cluster<T, VV>(a, stream)
                     : launch_two_phase<T, VV>(a, stream);
  }
  if (a.V == 1 && path == 1) return launch_two_phase<T, 1>(a, stream);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  path: 0 = cluster (K blocks a
// sample, in one cluster), 1 = two_phase (K row tiles a sample; ws holds
// N*K*2*C floats).  V: channels per vector; threads: a multiple of C / V;
// smem: dynamic shared-memory bytes per block.  Returns a cudaError_t (0 on
// success), -1 for arguments the kernels do not take, or -2 when the card
// cannot hold one cluster of this shape.
extern "C" int gn_swish_launch(int dtype, const void* x, const float* scale,
                               const float* bias, void* y, float* ws, int N,
                               int HW, int C, int G, float eps, int swish,
                               int path, int K, int V, int threads, int smem,
                               void* stream) {
  if (N < 1 || HW < 1 || C < 1 || G < 1 || C % G || K < 1 || V < 1 ||
      C % V || threads < 1 || threads > MAX_THREADS ||
      threads % (C / V) || smem < 0 || smem > MAX_SMEM ||
      (path != 0 && path != 1))
    return -1;
  const Args a{x, scale, bias, y, ws, N, HW, C, G, swish != 0, K, V,
               threads, smem, eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(path, a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(path, a, s);
  return -1;
}
