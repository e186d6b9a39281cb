// Fused GroupNorm-prologue + 3x3 same conv + epilogue with per-channel
// moments, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pnpflow_tpu/ops/fused_conv_gn.py:_kernel (launched
// by _conv3x3_gn_impl, entry conv3x3_gn).  Per sample n, output pixel p and
// output channel o:
//
//   u      = x[n, q, c] * a[n, c] + b'[n, c]          (prologue, optional)
//   xin    = cast_to_T(u * sigmoid(u))                 zero outside the image
//   acc    = sum_{tap, c} xin[n, p + tap, c] * w[tap, c, o]   (fp32)
//   v      = acc + bias[o] (+ sample_bias[n, o]) (+ residual[n, p, o])
//   y      = cast_to_T(v)
//   mom    = (sum_p y, sum_p y^2) in fp32, of the value as written
//
// The halo is zero AFTER the prologue: an out-of-image tap contributes 0,
// never swish(b').
//
// Design.  An implicit GEMM on the CUDA cores with M = H*W pixels,
// N = CO, K = 9*C: one block of 256 threads per (sample, 32- or 64-wide
// output-channel tile) walks every 64-pixel row tile of its sample, so it
// owns its channels' moments outright and reduces them in a fixed order
// (deterministic, no atomics).  Each K step stages a 64x16 input tile (with
// the prologue applied as it is staged) and a 16xBN weight tile in shared
// memory as fp32; each thread accumulates a 4xTN register tile.  bf16 inputs
// are widened to fp32 on staging, so both dtypes run at the fp32 FMA rate;
// wgmma/TMA and filling all SMs at small batch are later work.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;   // output pixels per tile
constexpr int BK = 16;   // input channels per K step
constexpr int THREADS = 256;

enum Flags { HAS_PROLOGUE = 1, HAS_SAMPLE_BIAS = 2, HAS_RESIDUAL = 4,
             EMIT_MOMENTS = 8 };

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

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_gn_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ pa, const float* __restrict__ pb,
                  const float* __restrict__ sb, const T* __restrict__ res,
                  T* __restrict__ y, float* __restrict__ mom,
                  int H, int W, int C, int CO, int flags) {
  constexpr int TN = BN / 16;  // output channels per thread
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  __shared__ float red[2][16][BN];

  const int n = blockIdx.y;
  const int co0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group of the register tile
  const int ty = tid >> 4;   // row group of the register tile
  const int HW = H * W;
  const bool prologue = flags & HAS_PROLOGUE;

  const T* xn = x + (size_t)n * HW * C;
  const float* pan = pa + (size_t)n * C;
  const float* pbn = pb + (size_t)n * C;

  // staging roles: A = 64 pixels x 16 channels, 4 channels per thread;
  // B = 16 channels x BN outputs, TN outputs per thread
  const int am = tid >> 2;
  const int ak = (tid & 3) * 4;
  const int bk = tid >> 4;
  const int bc = (tid & 15) * TN;

  float msum[TN], msq[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) msum[j] = msq[j] = 0.f;

  for (int m0 = 0; m0 < HW; m0 += BM) {
    float acc[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    const int p = m0 + am;
    const int py = p / W, px = p - (p / W) * W;
    const bool pvalid = p < HW;

    for (int tap = 0; tap < 9; ++tap) {
      const int iy = py + tap / 3 - 1;
      const int ix = px + tap % 3 - 1;
      const bool inb = pvalid && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const T* xp = inb ? xn + ((size_t)iy * W + ix) * C : xn;
      const T* wt = w + (size_t)tap * C * CO;

      for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + ak + j;
          float v = 0.f;
          if (inb && c < C) {
            v = to_f(xp[c]);
            if (prologue) {
              const float u = v * pan[c] + pbn[c];
              v = to_f(from_f<T>(u / (1.f + expf(-u))));
            }
          }
          As[ak + j][am] = v;
        }
        {
          const int c = c0 + bk;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int co = co0 + bc + j;
            Bs[bk][bc + j] =
                (c < C && co < CO) ? to_f(wt[(size_t)c * CO + co]) : 0.f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          float a[4], b[TN];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = m0 + ty * 4 + i;
      if (q >= HW) continue;
      const size_t row = ((size_t)n * HW + q) * CO;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int co = co0 + tx * TN + j;
        if (co >= CO) continue;
        float v = acc[i][j] + bias[co];
        if (flags & HAS_SAMPLE_BIAS) v += sb[(size_t)n * CO + co];
        if (flags & HAS_RESIDUAL) v += to_f(res[row + co]);
        const T o = from_f<T>(v);
        y[row + co] = o;
        const float of = to_f(o);
        msum[j] += of;
        msq[j] += of * of;
      }
    }
  }

  if (flags & EMIT_MOMENTS) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      red[0][ty][tx * TN + j] = msum[j];
      red[1][ty][tx * TN + j] = msq[j];
    }
    __syncthreads();
    if (tid < BN && co0 + tid < CO) {
      float s = 0.f, q = 0.f;
      for (int r = 0; r < 16; ++r) {
        s += red[0][r][tid];
        q += red[1][r][tid];
      }
      mom[((size_t)n * 2 + 0) * CO + co0 + tid] = s;
      mom[((size_t)n * 2 + 1) * CO + co0 + tid] = q;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* pa,
           const void* pb, const void* sb, const void* res, void* y,
           void* mom, int N, int H, int W, int C, int CO, int flags,
           cudaStream_t stream) {
  const dim3 block(THREADS);
  if (CO <= 32) {
    const dim3 grid((CO + 31) / 32, N);
    conv3x3_gn_kernel<T, 32><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)w, (const float*)bias, (const float*)pa,
        (const float*)pb, (const float*)sb, (const T*)res, (T*)y,
        (float*)mom, H, W, C, CO, flags);
  } else {
    const dim3 grid((CO + 63) / 64, N);
    conv3x3_gn_kernel<T, 64><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)w, (const float*)bias, (const float*)pa,
        (const float*)pb, (const float*)sb, (const T*)res, (T*)y,
        (float*)mom, H, W, C, CO, flags);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success),
// or -1 for arguments the kernel does not take.
extern "C" int conv3x3_gn_launch(int dtype, const void* x, const void* w,
                                 const void* bias, const void* pa,
                                 const void* pb, const void* sb,
                                 const void* res, void* y, void* mom, int N,
                                 int H, int W, int C, int CO, int flags,
                                 void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || CO < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, w, bias, pa, pb, sb, res, y, mom, N, H, W, C, CO,
                         flags, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bias, pa, pb, sb, res, y, mom, N, H,
                                 W, C, CO, flags, s);
  return -1;
}
