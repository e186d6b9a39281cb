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
// Bound: bytes (one read of x, one write of y; at most K*K = 64 FMAs per
// output).  Design: one thread per output pixel and group of V channels (V
// = 4 where C allows and the pointers are aligned, else 1), C innermost, so
// a warp loads neighbouring channels of one input pixel per tap as 8- or
// 16-byte vectors; the padded and zero-inserted image never exists in
// memory, and taps that land on an inserted zero or outside the image are
// skipped.  The taps travel by value in the kernel's parameter space.
// K = 4 with up = 1 or 2 (the NCSN++ sites) is compiled with K and up known,
// so the loops unroll and the zero-insertion test is a mask; other K <= 8
// and up take the general loop.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 8;
constexpr int THREADS = 256;

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

// KT, UT > 0: K and up known at compile time; 0: from the arguments.
template <typename T, int KT, int UT, int V>
__global__ void __launch_bounds__(THREADS)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Taps taps,
                 int K_arg, int H, int W, int C, int OH, int OW, int up_arg,
                 int down, int pad0, int total) {
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
void launch_one(const void* x, void* y, const Taps& taps, int K, int N,
                int H, int W, int C, int OH, int OW, int up, int down,
                int pad0, cudaStream_t stream) {
  const long long total = (long long)N * OH * OW * (C / V);
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  upfirdn2d_kernel<T, KT, UT, V><<<blocks, THREADS, 0, stream>>>(
      (const T*)x, (T*)y, taps, K, H, W, C, OH, OW, up, down, pad0,
      (int)total);
}

template <typename T, int V>
void launch_v(const void* x, void* y, const Taps& taps, int K, int N, int H,
              int W, int C, int OH, int OW, int up, int down, int pad0,
              cudaStream_t s) {
  if (K == 4 && up == 1)
    launch_one<T, 4, 1, V>(x, y, taps, K, N, H, W, C, OH, OW, up, down, pad0,
                           s);
  else if (K == 4 && up == 2)
    launch_one<T, 4, 2, V>(x, y, taps, K, N, H, W, C, OH, OW, up, down, pad0,
                           s);
  else
    launch_one<T, 0, 0, V>(x, y, taps, K, N, H, W, C, OH, OW, up, down, pad0,
                           s);
}

template <typename T>
int launch(const void* x, void* y, const Taps& taps, int K, int N, int H,
           int W, int C, int OH, int OW, int up, int down, int pad0,
           cudaStream_t stream) {
  constexpr int V = 4;
  const uintptr_t align = sizeof(T) * V;
  if (C % V == 0 && (uintptr_t)x % align == 0 && (uintptr_t)y % align == 0)
    launch_v<T, V>(x, y, taps, K, N, H, W, C, OH, OW, up, down, pad0, stream);
  else
    launch_v<T, 1>(x, y, taps, K, N, H, W, C, OH, OW, up, down, pad0, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  taps: host pointer to K*K floats,
// already flipped.  Returns a cudaError_t (0 on success), or -1 for
// arguments the kernel does not take.
extern "C" int upfirdn2d_launch(int dtype, const void* x, void* y,
                                const float* taps, int K, int N, int H,
                                int W, int C, int OH, int OW, int up,
                                int down, int pad0, void* stream) {
  if (K < 1 || K > MAX_K || N < 1 || H < 1 || W < 1 || C < 1 || OH < 1 ||
      OW < 1 || up < 1 || down < 1 || pad0 < 0)
    return -1;
  if ((long long)N * H * W * C >= (1LL << 31) ||
      (long long)N * OH * OW * C >= (1LL << 31))
    return -1;
  Taps t;
  for (int i = 0; i < MAX_K * MAX_K; ++i) t.v[i] = i < K * K ? taps[i] : 0.f;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, y, t, K, N, H, W, C, OH, OW, up, down, pad0, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, t, K, N, H, W, C, OH, OW, up, down,
                                 pad0, s);
  return -1;
}
