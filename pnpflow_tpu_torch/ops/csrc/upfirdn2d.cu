// upfirdn2d (zero-insert upsample, pad, K x K FIR, decimate) on NHWC, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pnpflow_tpu/ops/pallas_kernels.py:_fir2d_kernel
// (launched by _fir2d_padded, entry upfirdn2d_pallas).  For sample n, output
// pixel (oy, ox) and channel c:
//
//   y[n, oy, ox, c] = sum_{p, q < K} f[p][q] * z[n, oy*down + p - pad0,
//                                               ox*down + q - pad0, c]
//
// where f are the taps already flipped (a true convolution with k), and z is
// x zero-inserted by `up` (z[m] = x[m / up] when m % up == 0 and
// 0 <= m < H*up, else 0); padding beyond the image is zero too.  fp32
// accumulation, the result stored in x's dtype.
//
// Bound: bytes (one read of x, one write of y; 16 FMAs per output at the
// NCSN++ sites).  The TPU kernel holds the zero-inserted, padded image in
// VMEM; here neither that image nor its padding exists anywhere.  Three
// paths, which the wrapper's plan (ops/upfirdn.py:fir_plan) picks from the
// shape alone:
//
// * "tiled" (K = 4 with up 1 / down 2 or up 2 / down 1, the NCSN++ sites,
//   where a pixel is whole 16-byte vectors and x is 16-byte aligned).  A
//   block owns a TH x TW output tile of one sample and a chunk of CV
//   16-byte vectors of channels (CV = 8: one 128-byte line per pixel).  It
//   stages the input rows and columns its windows touch -- its footprint,
//   (2 TH + 2) x (2 TW + 2) pixels for down, (TH/2 + 2) x (TW/2 + 2) real
//   samples for up -- once into shared memory with 16-byte cp.async, whose
//   src-size 0 zero-fills the padding, and never builds the zero-inserted
//   image.  Polyphase: a thread owns RY x RX outputs (a 2 x 2 quad for up,
//   two horizontal neighbours for down) of one vector; which window cell
//   meets which tap of which output is fixed at compile time by up, down
//   and the phase PM = pad0 mod up, so the loops unroll into straight FMAs
//   on the taps that land on real samples.  fp32 accumulation in a fixed
//   order, no atomics: results repeat bit for bit.  Lanes run over a pixel's
//   vectors first, so each quarter-warp reads one 128-byte line of shared
//   memory and each store instruction writes whole 128-byte lines.
// * "narrow" (the same kinds where a pixel is not whole 16-byte vectors,
//   e.g. the C = 3 image pyramids, or x is not 16-byte aligned): the same
//   tiles, footprint and phase tables on scalar channels, staged as float;
//   a chunk is up to 32 channels, so a 12- or 6-byte pixel is read by
//   neighbouring lanes and a tile is one block.
// * "general" (any other K <= 8, up or down): one thread per output pixel and
//   group of V channels (V = 4 where C allows and x is aligned, else 1) that
//   finds its inputs by index arithmetic.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 8;
constexpr int THREADS = 256;          // general path
constexpr int TILE_THREADS = 512;      // tiled and narrow paths, at most
constexpr int SMEM_MAX = 48 * 1024;    // a block's, without opting in
enum { PATH_TILED = 0, PATH_NARROW = 1, PATH_GENERAL = 2 };
enum { ERR_ARGS = -1, ERR_PLAN = -3 };

struct Taps {
  float v[MAX_K * MAX_K];  // flipped taps, row-major K x K
};

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

// ------------------------------------------------------------ general path
// KT, UT > 0: K and up known at compile time; 0: from the arguments.
template <typename T, int KT, int UT, int V>
__global__ void __launch_bounds__(THREADS)
upfirdn2d_general_kernel(const T* __restrict__ x, T* __restrict__ y,
                         const Taps taps, int K_arg, int H, int W, int C,
                         int OH, int OW, int up_arg, int down, int pad0,
                         int total) {
  const int K = KT > 0 ? KT : K_arg;
  const int U = UT > 0 ? UT : up_arg;
  const int HU = H * U, WU = W * U;
  const int CV = C / V;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < total;
       j += (long long)gridDim.x * THREADS) {
    const int i = (int)j;  // total < 2^31
    const int c = (i % CV) * V;
    int r = i / CV;
    const int ox = r % OW;
    r /= OW;
    const int oy = r % OH;
    const int n = r / OH;
    const T* xn = x + (size_t)n * H * W * C + c;
    const int y0 = oy * down - pad0;
    const int x0 = ox * down - pad0;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
    for (int p = 0; p < (KT > 0 ? KT : MAX_K); ++p) {
      if (KT == 0 && p >= K) break;
      const int my = y0 + p;
      if (my < 0 || my >= HU || my % U != 0) continue;
      const T* row = xn + (size_t)(my / U) * W * C;
#pragma unroll
      for (int q = 0; q < (KT > 0 ? KT : MAX_K); ++q) {
        if (KT == 0 && q >= K) break;
        const int mx = x0 + q;
        if (mx < 0 || mx >= WU || mx % U != 0) continue;
        const Vec<T, V> v =
            *reinterpret_cast<const Vec<T, V>*>(row + (size_t)(mx / U) * C);
        const float tap = taps.v[p * K + q];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(tap, to_f(v.v[e]), acc[e]);
      }
    }
    Vec<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = from_f<T>(acc[e]);
    *reinterpret_cast<Vec<T, V>*>(y + (size_t)i * V) = o;
  }
}

template <typename T, int KT, int UT, int V>
void launch_general_one(const void* x, void* y, const Taps& taps, int K,
                        int N, int H, int W, int C, int OH, int OW, int up,
                        int down, int pad0, cudaStream_t stream) {
  const long long total = (long long)N * OH * OW * (C / V);
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  upfirdn2d_general_kernel<T, KT, UT, V><<<blocks, THREADS, 0, stream>>>(
      (const T*)x, (T*)y, taps, K, H, W, C, OH, OW, up, down, pad0,
      (int)total);
}

template <typename T, int V>
void launch_general_v(const void* x, void* y, const Taps& taps, int K, int N,
                      int H, int W, int C, int OH, int OW, int up, int down,
                      int pad0, cudaStream_t s) {
  if (K == 4 && up == 1)
    launch_general_one<T, 4, 1, V>(x, y, taps, K, N, H, W, C, OH, OW, up,
                                   down, pad0, s);
  else if (K == 4 && up == 2)
    launch_general_one<T, 4, 2, V>(x, y, taps, K, N, H, W, C, OH, OW, up,
                                   down, pad0, s);
  else
    launch_general_one<T, 0, 0, V>(x, y, taps, K, N, H, W, C, OH, OW, up,
                                   down, pad0, s);
}

template <typename T>
int launch_general(const void* x, void* y, const Taps& taps, int K, int N,
                   int H, int W, int C, int OH, int OW, int up, int down,
                   int pad0, cudaStream_t stream) {
  constexpr int V = 4;
  const uintptr_t align = sizeof(T) * V;
  if (C % V == 0 && (uintptr_t)x % align == 0 && (uintptr_t)y % align == 0)
    launch_general_v<T, V>(x, y, taps, K, N, H, W, C, OH, OW, up, down, pad0,
                           stream);
  else
    launch_general_v<T, 1>(x, y, taps, K, N, H, W, C, OH, OW, up, down, pad0,
                           stream);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- tiled and narrow paths
// Geometry of the K = 4 kinds, the same formulas as fir_plan and
// fir_phase_table in ops/upfirdn.py.  A thread owns RY x RX outputs; the
// next thread's outputs start SY rows / SX columns further in the
// footprint; its window is WH x WW footprint cells.  Output (RY j + ry,
// RX i + rx) of a tile meets tap (p, q) at window cell (wy, wx) with
// p = wy up + PM - ry down (valid where 0 <= p < K), likewise q.
constexpr int TK = 4;

template <int U, int D>
struct Kind {
  static constexpr int RY = U;
  static constexpr int RX = (U == 1 && D == 2) ? 2 : U;
  static constexpr int SY = RY * D / U;
  static constexpr int SX = RX * D / U;
};

__host__ __device__ constexpr int window(int r_count, int U, int D,
                                        int PM) {
  int w = 0;
  for (int r = 0; r < r_count; ++r)
    for (int p = 0; p < TK; ++p) {
      const int m = r * D + p - PM;
      if (m >= 0 && m % U == 0 && m / U + 1 > w) w = m / U + 1;
    }
  return w;
}

struct Taps4 {
  float v[TK * TK];
};

// A shared-memory cell: V channels of one footprint pixel.  V > 1: one
// 16-byte vector, copied as it lies in device memory; V = 1: one channel,
// staged as float.
template <typename T, int V> struct Cell;
template <> struct Cell<float, 4> {
  using S = float4;
  __device__ static void to_f(const S& s, float (&f)[4]) {
    f[0] = s.x; f[1] = s.y; f[2] = s.z; f[3] = s.w;
  }
  __device__ static void store(float* dst, const float (&f)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Cell<__nv_bfloat16, 8> {
  using S = uint4;
  __device__ static void to_f(const S& s, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&s);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 t = __bfloat1622float2(h[e]);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
  }
  __device__ static void store(__nv_bfloat16* dst, const float (&f)[8]) {
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    *reinterpret_cast<uint4*>(dst) = o;
  }
};
template <typename T> struct Cell<T, 1> {
  using S = float;
  __device__ static void to_f(const S& s, float (&f)[1]) { f[0] = s; }
  __device__ static void store(T* dst, const float (&f)[1]) {
    *dst = from_f<T>(f[0]);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// Block (CV, IT, JZ): threadIdx.x is the cell of the chunk (a 16-byte
// vector, or a channel on the narrow path), threadIdx.y the task column,
// threadIdx.z strides over the JT task rows.  Grid (chunks, tiles, N).
template <typename T, int V, int U, int D, int PM>
__global__ void __launch_bounds__(TILE_THREADS)
upfirdn2d_tile_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const Taps4 taps, int H, int W, int C, int OH, int OW,
                      int Q, int JT, int FH, int FW, int tiles_x) {
  using K_ = Kind<U, D>;
  constexpr int RY = K_::RY, RX = K_::RX, SY = K_::SY, SX = K_::SX;
  constexpr int WH = window(RY, U, D, PM), WW = window(RX, U, D, PM);
  using C_ = Cell<T, V>;
  using S = typename C_::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* foot = reinterpret_cast<S*>(smem_raw);

  const int cv = blockDim.x, it = blockDim.y, jz = blockDim.z;
  const int v = threadIdx.x, ti = threadIdx.y, tz = threadIdx.z;
  const int tile_y = blockIdx.y / tiles_x;           // once per block
  const int tile_x = blockIdx.y - tile_y * tiles_x;
  const int n = blockIdx.z;
  const int oy0 = tile_y * RY * JT, ox0 = tile_x * RX * it;
  const int iy0 = oy0 * D / U - Q, ix0 = ox0 * D / U - Q;
  const int c = blockIdx.x * cv * V + v * V;          // this lane's channels

  // stage the footprint: pixel (fy, fx) walks the block's threads with a
  // fixed stride, carried from one step to the next without division.  The
  // narrow path's scalar loads go LOADS at a time, all issued before the
  // first is stored, so a small tile does not wait for them one by one.
  constexpr int LOADS = V > 1 ? 1 : 4;
  const T* xn = x + (size_t)n * H * W * C + c;
  const int first = ti + it * tz, stride = it * jz;
  int fy = first / FW, fx = first - fy * FW;
  const int dy = stride / FW, dx = stride - dy * FW;
  while (fy < FH) {
    float val[LOADS];
    int at[LOADS];
#pragma unroll
    for (int b = 0; b < LOADS; ++b) {
      at[b] = -1;
      if (b > 0 && fy >= FH) continue;
      const int iy = iy0 + fy, ix = ix0 + fx;
      const bool ok =
          (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
      const T* src = ok ? xn + ((size_t)iy * W + ix) * C : x;
      const int cell = (fy * FW + fx) * cv + v;
      if constexpr (V > 1) {
        cp_async16(foot + cell, src, ok ? 16 : 0);
      } else {
        val[b] = ok ? to_f(*src) : 0.f;
        at[b] = cell;
      }
      fx += dx;
      fy += dy;
      if (fx >= FW) { fx -= FW; ++fy; }
    }
    if constexpr (V == 1) {
#pragma unroll
      for (int b = 0; b < LOADS; ++b)
        if (at[b] >= 0) foot[at[b]] = val[b];
    }
  }
  if constexpr (V > 1) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();

  const int ox = ox0 + RX * ti;
  if (ox >= OW) return;
  for (int j = tz; j < JT; j += jz) {
    const int oy = oy0 + RY * j;
    if (oy >= OH) break;
    const S* win = foot + ((j * SY) * FW + ti * SX) * cv + v;
    float acc[RY][RX][V];
#pragma unroll
    for (int ry = 0; ry < RY; ++ry)
#pragma unroll
      for (int rx = 0; rx < RX; ++rx)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[ry][rx][e] = 0.f;
#pragma unroll
    for (int wy = 0; wy < WH; ++wy) {
#pragma unroll
      for (int wx = 0; wx < WW; ++wx) {
        float f[V];
        C_::to_f(win[(wy * FW + wx) * cv], f);
#pragma unroll
        for (int ry = 0; ry < RY; ++ry) {
          const int p = wy * U + PM - ry * D;
#pragma unroll
          for (int rx = 0; rx < RX; ++rx) {
            const int q = wx * U + PM - rx * D;
            if (p >= 0 && p < TK && q >= 0 && q < TK) {
              const float tap = taps.v[p * TK + q];
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[ry][rx][e] = fmaf(tap, f[e], acc[ry][rx][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int ry = 0; ry < RY; ++ry) {
      if (oy + ry >= OH) break;
      T* row = y + ((size_t)n * OH + oy + ry) * OW * C + c;
#pragma unroll
      for (int rx = 0; rx < RX; ++rx)
        if (ox + rx < OW) C_::store(row + (size_t)(ox + rx) * C, acc[ry][rx]);
    }
  }
}

template <typename T, int V, int U, int D, int PM>
int launch_tile(const void* x, void* y, const Taps4& taps, int N, int H,
                int W, int C, int OH, int OW, int pad0, int cv, int it,
                int jt, int jz, int fh, int fw, int tiles_x, int tiles_y,
                int smem, cudaStream_t stream) {
  using K_ = Kind<U, D>;
  constexpr int WH = window(K_::RY, U, D, PM), WW = window(K_::RX, U, D, PM);
  // the plan's footprint and shared memory must be the kernel's
  if (fh != (jt - 1) * K_::SY + WH || fw != (it - 1) * K_::SX + WW ||
      smem != fh * fw * cv * (int)sizeof(typename Cell<T, V>::S) ||
      C % (cv * V) != 0)
    return ERR_PLAN;
  const dim3 grid(C / (cv * V), tiles_x * tiles_y, N);
  const dim3 block(cv, it, jz);
  upfirdn2d_tile_kernel<T, V, U, D, PM><<<grid, block, smem, stream>>>(
      (const T*)x, (T*)y, taps, H, W, C, OH, OW, pad0 / U, jt, fh, fw,
      tiles_x);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_kind(const void* x, void* y, const Taps4& taps, int N, int H,
                int W, int C, int OH, int OW, int up, int down, int pad0,
                int cv, int it, int jt, int jz, int fh, int fw, int tiles_x,
                int tiles_y, int smem, cudaStream_t s) {
  if (up == 1 && down == 2)
    return launch_tile<T, V, 1, 2, 0>(x, y, taps, N, H, W, C, OH, OW, pad0,
                                      cv, it, jt, jz, fh, fw, tiles_x,
                                      tiles_y, smem, s);
  if (up == 2 && down == 1 && pad0 % 2 == 0)
    return launch_tile<T, V, 2, 1, 0>(x, y, taps, N, H, W, C, OH, OW, pad0,
                                      cv, it, jt, jz, fh, fw, tiles_x,
                                      tiles_y, smem, s);
  if (up == 2 && down == 1)
    return launch_tile<T, V, 2, 1, 1>(x, y, taps, N, H, W, C, OH, OW, pad0,
                                      cv, it, jt, jz, fh, fw, tiles_x,
                                      tiles_y, smem, s);
  return ERR_ARGS;
}

template <typename T>
int launch_tiled(int path, const void* x, void* y, const float* taps, int N,
                 int H, int W, int C, int OH, int OW, int up, int down,
                 int pad0, int cv, int it, int jt, int jz, int fh, int fw,
                 int tiles_x, int tiles_y, int smem, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (cv < 1 || it < 1 || jz < 1 || jt < jz || cv * it * jz > TILE_THREADS ||
      tiles_x < 1 || tiles_y < 1 || (long long)tiles_x * tiles_y > 65535 ||
      N > 65535 || smem > SMEM_MAX)
    return ERR_ARGS;
  Taps4 t;
  for (int i = 0; i < TK * TK; ++i) t.v[i] = taps[i];
  if (path == PATH_TILED) {
    if ((C * (int)sizeof(T)) % 16 != 0 || (uintptr_t)x % 16 != 0 ||
        (uintptr_t)y % 16 != 0)
      return ERR_ARGS;
    return launch_kind<T, V>(x, y, t, N, H, W, C, OH, OW, up, down, pad0, cv,
                             it, jt, jz, fh, fw, tiles_x, tiles_y, smem, s);
  }
  return launch_kind<T, 1>(x, y, t, N, H, W, C, OH, OW, up, down, pad0, cv,
                           it, jt, jz, fh, fw, tiles_x, tiles_y, smem, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  path: 0 tiled, 1 narrow, 2 general.
// taps: host pointer to K*K floats, already flipped.  cv .. smem: the
// tiled and narrow paths' plan (ignored by the general path): cells of a
// chunk, task columns, task rows, thread rows, footprint rows and columns,
// tiles across and down, bytes of dynamic shared memory.  Returns a
// cudaError_t (0 on success), -1 for arguments the kernel does not take, or
// -3 for a plan the kernel's geometry disagrees with.
extern "C" int upfirdn2d_launch(int dtype, int path, const void* x, void* y,
                                const float* taps, int K, int N, int H,
                                int W, int C, int OH, int OW, int up,
                                int down, int pad0, int cv, int it, int jt,
                                int jz, int fh, int fw, int tiles_x,
                                int tiles_y, int smem, void* stream) {
  if (K < 1 || K > MAX_K || N < 1 || H < 1 || W < 1 || C < 1 || OH < 1 ||
      OW < 1 || up < 1 || down < 1 || pad0 < 0)
    return ERR_ARGS;
  if ((long long)N * H * W * C >= (1LL << 31) ||
      (long long)N * OH * OW * C >= (1LL << 31))
    return ERR_ARGS;
  cudaStream_t s = (cudaStream_t)stream;
  if (path == PATH_GENERAL) {
    Taps t;
    for (int i = 0; i < MAX_K * MAX_K; ++i)
      t.v[i] = i < K * K ? taps[i] : 0.f;
    if (dtype == 0)
      return launch_general<float>(x, y, t, K, N, H, W, C, OH, OW, up, down,
                                   pad0, s);
    if (dtype == 1)
      return launch_general<__nv_bfloat16>(x, y, t, K, N, H, W, C, OH, OW,
                                           up, down, pad0, s);
    return ERR_ARGS;
  }
  if ((path != PATH_TILED && path != PATH_NARROW) || K != TK) return ERR_ARGS;
  if (dtype == 0)
    return launch_tiled<float>(path, x, y, taps, N, H, W, C, OH, OW, up,
                               down, pad0, cv, it, jt, jz, fh, fw, tiles_x,
                               tiles_y, smem, s);
  if (dtype == 1)
    return launch_tiled<__nv_bfloat16>(path, x, y, taps, N, H, W, C, OH, OW,
                                       up, down, pad0, cv, it, jt, jz, fh, fw,
                                       tiles_x, tiles_y, smem, s);
  return ERR_ARGS;
}
