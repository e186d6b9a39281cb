// Fused GroupNorm-prologue + 3x3 same conv + epilogue with per-channel
// moments, for NVIDIA Hopper (sm_90a), on the tensor cores.
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
// Bound on an H100: in bf16, bytes (x, w, residual and y over 3.35 TB/s; the
// 2*N*H*W*9*C*CO products take less at 989 TFLOP/s); in fp32, operations:
// fp32 accuracy on the tensor cores takes three TF32 products per product
// (3xTF32: big*big + big*small + small*big with big = tf32(v), small =
// tf32(v - big)), at 495 TFLOP/s, which is still less time than one product
// at the CUDA cores' 67 TFLOP/s.
//
// Design.  An implicit GEMM with M = N*H*W output pixels, N = CO and
// K = 9*C.  A block owns BM pixels (R whole rows of TW columns of one sample,
// R*TW = BM) by BN output channels; the wrapper picks (BM, BN, TW) per call
// so that small batches still give the card's 132 SMs enough blocks.  Each
// warp computes a 32x32 tile with mma.sync (bf16: m16n8k16 -> f32; fp32:
// m16n8k8 TF32, three per step).
//
//  * The input is read once per chunk of 64 bytes of channels (32 bf16 or
//    16 fp32), not once per tap: cp.async brings the tile's pixels plus a
//    1-pixel halo into a raw buffer while the previous chunk's MMAs run;
//    then the block applies the prologue to it, rounds to T, writes 0 for
//    out-of-image pixels and channels >= C, and stores it as the halo tile.
//    The 9 taps are shifted windows of that tile, read by ldmatrix with one
//    row address per lane; the pixel stride is padded to 80 bytes so the 8
//    rows of an ldmatrix phase fall on distinct banks.  In bf16 the swish is
//    one hardware tanh (see swish()), which halves the prologue's cost.
//  * Weights, whose HWIO rows are already K x CO row-major, arrive by
//    16-byte cp.async in a 2-stage ring, one (chunk, kernel row) tile of
//    three taps per stage, so one barrier serves 3 taps; rows past C are
//    zero-filled.  bf16 B fragments come from ldmatrix.trans; fp32 ones from
//    padded scalar loads, split as loaded.
//  * bf16 blocks are held to 80 registers a thread so that 24 warps fit on
//    an SM; fp32 keeps its ~100 (capping it spills the TF32 halves).
//  * Moments: each block writes its per-channel partial (sum, sumsq) to a
//    workspace (N, T, 2, CO), T = pixel tiles per sample, summing its pixels
//    in a fixed order (registers, then a butterfly over lanes, then warps in
//    order); a second kernel sums the T partials in order.  No atomics: y
//    and the moments repeat bit for bit.
//
// Plain C interface for ctypes; the launches go on the caller's stream and
// the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KBYTES = 64;    // bytes of input channels per K chunk
constexpr int PSTRIDE = 80;   // halo tile pixel stride (bytes), bank-padded
constexpr int STAGES = 2;     // weight ring depth, one kernel row a stage
constexpr int MI = 2;         // m16 tiles per warp: a warp computes 32 x 32
constexpr int MIN_WARPS_BF16 = 24;  // bf16 blocks resident per SM, in warps
constexpr size_t MAX_SMEM = 200 * 1024;

enum Flags { HAS_PROLOGUE = 1, HAS_SAMPLE_BIAS = 2, HAS_RESIDUAL = 4,
             EMIT_MOMENTS = 8 };

struct Params {
  const void* x;
  const void* w;
  const float* bias;
  const float* pa;
  const float* pb;
  const float* sb;
  const void* res;
  void* y;
  float* ws;
  int N, H, W, C, CO, flags;
  int TW, R, tiles_x, T;  // tile width and rows, tiles per row / per sample
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

// 16-byte async copy; bytes past src_bytes (0 or 16) are written as zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// u * sigmoid(u).  fp32: fast exp form, relative error near 1e-6.  bf16: one
// MUFU tanh, u/2 * (1 + tanh(u/2)), whose 2^-10 relative error is below the
// 2^-8 step of the bf16 the value is rounded to.
template <bool BF16>
__device__ __forceinline__ float swish(float u) {
  if constexpr (BF16) {
    float th;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(0.5f * u));
    return fmaf(0.5f * u, th, 0.5f * u);
  } else {
    return __fdividef(u, 1.f + __expf(-u));
  }
}

// v = big + small, both TF32 (round to nearest): the 3xTF32 split
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& big,
                                           uint32_t& small) {
  const float f = __uint_as_float(v);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(f));
  const float rest = f - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

template <typename T, int BN>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);       // elements per 16 bytes
  static constexpr int KCH = KBYTES / sizeof(T);   // channels per chunk
  // weight row stride (bytes): bank-padded for ldmatrix.trans (bf16) and
  // for the (k = lane % 4, n = lane / 4) scalar loads (fp32)
  static constexpr int WSTRIDE = BN * (int)sizeof(T) + (sizeof(T) == 2 ? 16 : 32);
  static constexpr int WTAP = KCH * WSTRIDE;    // one tap's K x BN tile
  static constexpr int WSTAGE = 3 * WTAP;         // one kernel row: 3 taps
};

template <typename T, int BM, int BN>
size_t smem_bytes(int TW) {
  const int hp = (BM / TW + 2) * (TW + 2);
  return (size_t)hp * (PSTRIDE + KBYTES) + STAGES * Layout<T, BN>::WSTAGE +
         2 * (BM / (16 * MI)) * BN * sizeof(float);
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(
    BM * BN / (16 * MI),
    (sizeof(T) == 2 ? MIN_WARPS_BF16 : 0) / (BM * BN / (16 * MI) / 32))
conv3x3_gn_kernel(const Params p) {
  using L = Layout<T, BN>;
  constexpr int THREADS = BM * BN / (16 * MI);
  constexpr int WN = BN / 32, WM = BM / (16 * MI);
  constexpr int VEC = L::VEC, KCH = L::KCH;
  constexpr bool BF16 = sizeof(T) == 2;
  static_assert(THREADS % 4 == 0, "a thread keeps one 16-byte channel slice");

  extern __shared__ __align__(16) uint8_t smem[];
  const int TW = p.TW, R = p.R, HW2 = TW + 2;
  const int HP = (R + 2) * HW2;
  // halo pixel px -> (row, column) without an integer division: exact,
  // since px < 2^16 keeps (px + 0.5) / HW2 clear of the next integer
  const float inv_hw2 = 1.f / HW2;
  auto halo_row = [&](int px) {
    return __float2int_rz(((float)px + 0.5f) * inv_hw2);
  };
  uint8_t* halo = smem;
  uint8_t* raw = halo + (size_t)HP * PSTRIDE;
  uint8_t* wring = raw + (size_t)HP * KBYTES;
  float* red = (float*)(wring + STAGES * L::WSTAGE);

  const int H = p.H, W = p.W, C = p.C, CO = p.CO;
  const int co_tiles = CO / BN;
  const int bid = blockIdx.x;
  const int co0 = (bid % co_tiles) * BN;
  const int ptile = bid / co_tiles;
  const int n = ptile / p.T, tile = ptile % p.T;
  const int y0 = (tile / p.tiles_x) * R, x0 = (tile % p.tiles_x) * TW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WN) * 16 * MI, wn0 = (warp % WN) * 32;
  const int g = lane >> 2, t = lane & 3;
  const bool prologue = p.flags & HAS_PROLOGUE;
  // 16-byte input vectors need whole vectors of channels per pixel
  const bool fast = C % VEC == 0 && ((uintptr_t)p.x & 15) == 0;

  const T* xn = (const T*)p.x + (size_t)n * H * W * C;
  const T* w = (const T*)p.w;

  // ---- staging: raw input chunk by cp.async, weights (chunk, kernel row)
  auto copy_raw = [&](int c0) {
    for (int i = tid; i < HP * 4; i += THREADS) {
      const int px = i >> 2, j = i & 3;
      const int hy = halo_row(px), hx = px - hy * HW2;
      const int yy = y0 - 1 + hy, xx = x0 - 1 + hx, c = c0 + j * VEC;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < C)
        cp_async16(smem_u32(raw + px * KBYTES + j * 16),
                   xn + ((size_t)yy * W + xx) * C + c, 16);
    }
  };
  auto copy_w = [&](int s) {  // step s: chunk s / 3, kernel row s % 3
    const int ci = s / 3, ky = s - ci * 3;
    const int c0 = ci * KCH;
    uint8_t* dst = wring + (s % STAGES) * L::WSTAGE;
    constexpr int VPR = BN / VEC;  // 16-byte vectors per weight row
    for (int i = tid; i < 3 * KCH * VPR; i += THREADS) {
      const int row = i / VPR, v = i - row * VPR;  // row = kx * KCH + k
      const int kx = row / KCH, k = row - kx * KCH;
      const int c = c0 + k;
      const T* src = w + ((size_t)(ky * 3 + kx) * C + (c < C ? c : C - 1)) *
                             CO + co0 + v * VEC;
      cp_async16(smem_u32(dst + row * L::WSTRIDE + v * 16), src,
                 c < C ? 16 : 0);
    }
  };
  // raw (or, for a C the 16-byte copies cannot take, global) -> halo tile:
  // prologue, rounding to T, zero outside the image and past C
  auto stage_halo = [&](int c0) {
    const int j = tid & 3;
    const int cb = c0 + j * VEC;
    float a[VEC], b[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int c = cb + e;
      const bool on = prologue && c < C;
      a[e] = on ? p.pa[(size_t)n * C + c] : 1.f;
      b[e] = on ? p.pb[(size_t)n * C + c] : 0.f;
    }
    for (int i = tid; i < HP * 4; i += THREADS) {
      const int px = i >> 2;
      const int hy = halo_row(px), hx = px - hy * HW2;
      const int yy = y0 - 1 + hy, xx = x0 - 1 + hx;
      __align__(16) T out[VEC];
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        __align__(16) T in[VEC];
        if (fast) {
          *(uint4*)in = *(const uint4*)(raw + px * KBYTES + j * 16);
        } else {
          const T* src = xn + ((size_t)yy * W + xx) * C;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            in[e] = cb + e < C ? src[cb + e] : from_f<T>(0.f);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float v = 0.f;
          if (cb + e < C) {
            v = to_f(in[e]);
            if (prologue) {
              const float u = v * a[e] + b[e];
              v = swish<BF16>(u);
            }
          }
          out[e] = from_f<T>(v);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[e] = from_f<T>(0.f);
      }
      *(uint4*)(halo + px * PSTRIDE + j * 16) = *(const uint4*)out;
    }
  };

  // ---- per-lane ldmatrix row addresses into the halo tile (tap (0, 0))
  uint32_t a_addr[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int m = wm0 + mi * 16 + (lane & 15);
    const int r = m / TW, cc = m - (m / TW) * TW;
    a_addr[mi] = smem_u32(halo) + (r * HW2 + cc) * PSTRIDE + (lane >> 4) * 16;
  }

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nch = (C + KCH - 1) / KCH;
  const int steps = 3 * nch;

  if (fast) copy_raw(0);
  copy_w(0);
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < STAGES - 1; ++j) {
    if (j < steps) copy_w(j);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  stage_halo(0);

  for (int s = 0; s < steps; ++s) {
    const int ci = s / 3, ky = s - ci * 3;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) copy_w(s + STAGES - 1);
    if (ky == 0 && ci + 1 < nch && fast) copy_raw((ci + 1) * KCH);
    cp_async_commit();

#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const uint8_t* ws = wring + (s % STAGES) * L::WSTAGE + kx * L::WTAP;
      const uint32_t tapoff = (ky * HW2 + kx) * PSTRIDE;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {  // 32 bytes of channels per MMA step
        uint32_t af[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(af[mi], a_addr[mi] + tapoff + ks * 32);
        if constexpr (BF16) {
          uint32_t bfr[4][2];
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            uint32_t r[4];
            ldmatrix_x4_trans(
                r, smem_u32(ws + (ks * 16 + (lane & 15)) * L::WSTRIDE +
                            (wn0 + nj * 16 + (lane >> 4) * 8) * 2));
            bfr[2 * nj][0] = r[0];
            bfr[2 * nj][1] = r[1];
            bfr[2 * nj + 1][0] = r[2];
            bfr[2 * nj + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
        } else {
          uint32_t abig[MI][4], asmall[MI][4];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32(af[mi][e], abig[mi][e], asmall[mi][e]);
          const float* wf = (const float*)ws;
          constexpr int WS = L::WSTRIDE / 4;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int col = wn0 + ni * 8 + g;
            uint32_t b0b, b0s, b1b, b1s;
            split_tf32(__float_as_uint(wf[(ks * 8 + t) * WS + col]), b0b, b0s);
            split_tf32(__float_as_uint(wf[(ks * 8 + t + 4) * WS + col]), b1b,
                       b1s);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              mma_tf32(acc[mi][ni], asmall[mi], b0b, b1b);
              mma_tf32(acc[mi][ni], abig[mi], b0s, b1s);
              mma_tf32(acc[mi][ni], abig[mi], b0b, b1b);
            }
          }
        }
      }
    }

    if (ky == 2 && ci + 1 < nch) {
      // the raw chunk went out with the group committed two steps ago; the
      // barrier also waits for every warp to be done with the halo
      cp_async_wait<2>();
      __syncthreads();
      stage_halo((ci + 1) * KCH);
    }
  }

  // ---- epilogue: + bias (+ sample bias) (+ residual), cast, store, moments
  const T* res = (const T*)p.res;
  T* y = (T*)p.y;
  float msum[4][2], msq[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
    msum[ni][0] = msum[ni][1] = msq[ni][0] = msq[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm0 + mi * 16 + g + half * 8;
      const int yy = y0 + m / TW, xx = x0 + m % TW;
      if (yy >= H || xx >= W) continue;
      const size_t row = (((size_t)n * H + yy) * W + xx) * CO;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = co0 + wn0 + ni * 8 + 2 * t;
        float v0 = acc[mi][ni][2 * half] + p.bias[co];
        float v1 = acc[mi][ni][2 * half + 1] + p.bias[co + 1];
        if (p.flags & HAS_SAMPLE_BIAS) {
          v0 += p.sb[(size_t)n * CO + co];
          v1 += p.sb[(size_t)n * CO + co + 1];
        }
        if (p.flags & HAS_RESIDUAL) {
          v0 += to_f(res[row + co]);
          v1 += to_f(res[row + co + 1]);
        }
        const T o0 = from_f<T>(v0), o1 = from_f<T>(v1);
        if constexpr (BF16) {
          __nv_bfloat162 pr;
          pr.x = o0;
          pr.y = o1;
          *(__nv_bfloat162*)(y + row + co) = pr;
        } else {
          *(float2*)(y + row + co) = make_float2(o0, o1);
        }
        const float f0 = to_f(o0), f1 = to_f(o1);
        msum[ni][0] += f0;
        msq[ni][0] += f0 * f0;
        msum[ni][1] += f1;
        msq[ni][1] += f1 * f1;
      }
    }
  }

  if (p.flags & EMIT_MOMENTS) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          msum[ni][j] += __shfl_xor_sync(0xffffffffu, msum[ni][j], off);
          msq[ni][j] += __shfl_xor_sync(0xffffffffu, msq[ni][j], off);
        }
    const int wm = warp / WN;
    if (lane < 4) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wn0 + ni * 8 + 2 * lane + j;
          red[(0 * WM + wm) * BN + col] = msum[ni][j];
          red[(1 * WM + wm) * BN + col] = msq[ni][j];
        }
    }
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += THREADS) {
      const int k = i / BN, col = i - k * BN;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < WM; ++r) s += red[(k * WM + r) * BN + col];
      p.ws[(((size_t)n * p.T + tile) * 2 + k) * CO + co0 + col] = s;
    }
  }
}

// mom[n, k, co] = sum over the T pixel tiles, in order, of ws[n, t, k, co]
__global__ void moments_reduce(const float* __restrict__ ws,
                               float* __restrict__ mom, int N, int T,
                               int CO) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * 2 * CO) return;
  const int n = i / (2 * CO), rem = i - n * 2 * CO;
  const float* src = ws + (size_t)n * T * 2 * CO + rem;
  float s = 0.f;
  for (int t = 0; t < T; ++t) s += src[(size_t)t * 2 * CO];
  mom[i] = s;
}

template <typename T, int BM, int BN>
int launch_tile(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, BM, BN>(p.TW);
  if (smem > MAX_SMEM) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_gn_kernel<T, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)p.N * p.T * (p.CO / BN);
  if (blocks >= (1LL << 31)) return -1;
  conv3x3_gn_kernel<T, BM, BN><<<(unsigned)blocks, BM * BN / (16 * MI), smem,
                                 stream>>>(p);
  return 0;
}

template <typename T>
int launch(const Params& p, int bm, int bn, cudaStream_t stream) {
  if (bm == 64 && bn == 32) return launch_tile<T, 64, 32>(p, stream);
  if (bm == 64 && bn == 64) return launch_tile<T, 64, 64>(p, stream);
  if (bm == 64 && bn == 128) return launch_tile<T, 64, 128>(p, stream);
  if (bm == 128 && bn == 32) return launch_tile<T, 128, 32>(p, stream);
  if (bm == 128 && bn == 64) return launch_tile<T, 128, 64>(p, stream);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (bm, bn, tw): the block's pixel tile
// (bm pixels as bm/tw rows of tw columns) and output-channel tile, as the
// wrapper's launch plan picks them.  ws: the (N, T, 2, CO) fp32 moment
// workspace, T = ceil(H / (bm/tw)) * ceil(W / tw), when moments are asked.
// Returns a cudaError_t (0 on success), or -1 for arguments the kernel does
// not take.
extern "C" int conv3x3_gn_launch(int dtype, const void* x, const void* w,
                                 const void* bias, const void* pa,
                                 const void* pb, const void* sb,
                                 const void* res, void* y, void* mom,
                                 void* ws, int N, int H, int W, int C, int CO,
                                 int flags, int bm, int bn, int tw,
                                 void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || CO < 1 || bn < 1 || CO % bn != 0 ||
      tw < 1 || tw > bm || bm % tw != 0 || ((uintptr_t)w & 15) != 0)
    return -1;
  Params p{x, w, (const float*)bias, (const float*)pa, (const float*)pb,
           (const float*)sb, res, y, (float*)ws, N, H, W, C, CO, flags,
           tw, bm / tw, 0, 0};
  p.tiles_x = (W + tw - 1) / tw;
  p.T = ((H + p.R - 1) / p.R) * p.tiles_x;
  cudaStream_t s = (cudaStream_t)stream;
  int err = -1;
  if (dtype == 0) err = launch<float>(p, bm, bn, s);
  if (dtype == 1) err = launch<__nv_bfloat16>(p, bm, bn, s);
  if (err != 0) return err;
  if (flags & EMIT_MOMENTS) {
    const int total = N * 2 * CO;
    moments_reduce<<<(total + 255) / 256, 256, 0, s>>>((const float*)ws,
                                                       (float*)mom, N, p.T,
                                                       CO);
  }
  return (int)cudaGetLastError();
}
