// Fused GroupNorm-prologue + 3x3 same conv + epilogue with per-channel
// moments, for NVIDIA Hopper (sm_90a): wgmma products fed by TMA.
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
// What bounds it on an H100.  bf16: bytes at the 64^2 and 32^2 U-Net sites
// (x, residual and y over 3.35 TB/s), operations at 16^2 and 8^2 (989
// TFLOP/s); fp32: operations, as 3xTF32 (big*big + big*small + small*big
// with big = tf32(v), small = tf32(v - big), at 495 TFLOP/s), still less
// time than one product on the CUDA cores.  In practice a block is a chain
// of memory latencies (the input, the coefficients, the residual, the
// moment ticket) around a prologue pass that is ALU-bound, so the design
// takes every global read off that chain that it can, and keeps the tensor
// cores fed between those points.
//
// Design.  An implicit GEMM with M = N*H*W output pixels, N = CO and
// K = 9*C in the order (64-byte channel chunk, tap, channel).
//
//  * Products: wgmma.mma_async m64nBNk16 bf16 or m64nBNk8 tf32 (fp32 as
//    three), fp32 accumulators in registers, both operands from shared
//    memory by matrix descriptor.  A is the halo tile after the prologue,
//    stored as 16-byte K planes (no swizzle); each m64 row block is 8 image
//    rows x 8 columns of one sample, so its 8 core matrices (8 pixels of a
//    row) are one halo row apart and a tap is a shift of the start address.
//    A from registers (by ldmatrix) would allow any tile width, but ptxas
//    serializes every wgmma whose A registers are written while an earlier
//    group is in flight, which a pipeline must do.  A step (one wgmma group) is a kernel row of 3 taps in bf16,
//    one tap in fp32; 1 (bf16) or 2 (fp32) groups stay in flight.
//  * Weights by TMA: the wrapper packs them once per weight tensor as
//    (CO, K) rows, fp32 as the TF32 big halves then the small ones (wgmma
//    takes TF32 B only K-major).  One producer warp keeps a ring of up to 8
//    stages (about 48 KB, no more stages than steps) full with
//    cp.async.bulk.tensor into 64-byte-swizzled tiles, each stage with a
//    full and an empty mbarrier; the consumer warpgroups spend no registers
//    or instructions on weight addresses.
//  * Input by TMA where its rows are whole 16-byte vectors and C is at
//    least a chunk: a 4-D map over NHWC with a box of (chunk, TW+2, R+2,
//    samples) at (c0, x0-1, y0-1, n0) brings each sample's halo with
//    hardware zero fill at the borders, never reading into a neighbouring
//    sample, two chunks ahead.  The consumers apply the prologue, round to
//    T (fp32: split into TF32 halves) and write the planes, zeroing
//    out-of-image pixels again (TMA's zero would become swish(b')); two
//    halo buffers let chunk c + 1 be staged while chunk c's groups run,
//    into the buffer of chunk c - 1 once a barrier shows every warpgroup
//    done with it (a thread stages pixels of every warpgroup's rows).
//    The C = 3 begin conv (6- or 12-byte rows, which no tensor map takes)
//    loads from global memory in the same pass.  In bf16 the swish is one
//    hardware tanh (see swish()).
//  * Off the block's chain: the prologue coefficients of every chunk, the
//    bias and the sample bias are read into shared memory once, while the
//    first TMA loads fly; the residual tile arrives by TMA at the start.
//  * Tiles: BM x BN = 64 x 32, 128 x (32, 64 or 128) or 256 x (32 or 64)
//    (1 or 2 consumer warpgroups of 1 or 2 m64 row blocks), as S samples x R
//    rows x TW columns (R and TW multiples of 8): two 8x8 samples share a
//    128-row tile, so the weights stream once per two samples.  The small
//    tiles are held to 2-3 blocks an SM, which the memory-bound sites need.
//    The wrapper's launch plan picks the tile per call so that small
//    batches still give the 132 SMs enough blocks.
//  * Moments in the same launch: each block sums its pixels per sample in a
//    fixed order (registers, a butterfly over lanes, then 16-row slices in
//    order); a sample with one tile writes them, else they go to an (N, T,
//    2, CO) workspace and the last block of each (sample group, channel
//    slice), elected by an atomic ticket, sums the T partials in tile order
//    and resets its ticket.  y and the moments repeat bit for bit.
//
// The tensor maps are encoded on the host in conv3x3_gn_launch by
// cuTensorMapEncodeTiled, whose address cudaGetDriverEntryPoint returns (so
// no library links -lcuda), and passed as __grid_constant__ parameters.
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the entry returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KBYTES = 64;    // bytes of input channels per chunk / K step
constexpr int MAX_S = 4;      // samples per tile: BM / 64 at most
constexpr size_t MAX_SMEM = 227 * 1024;

// Timing probes, which the port's build never defines (scripts/
// torch_conv_ab.py --probes builds them): CONV3X3_GN_RING_BYTES sizes the
// weight ring; CONV3X3_GN_WEIGHTS_ONCE loads each ring stage once and then
// reuses it (wrong products: the time of a call without the weight stream).
#ifndef CONV3X3_GN_RING_BYTES
#define CONV3X3_GN_RING_BYTES 49152
#endif

enum Flags { HAS_PROLOGUE = 1, HAS_SAMPLE_BIAS = 2, HAS_RESIDUAL = 4,
             EMIT_MOMENTS = 8 };

struct Params {
  const void* x;
  const float* bias;
  const float* pa;
  const float* pb;
  const float* sb;
  const void* res;
  void* y;
  float* ws;
  float* mom;
  int* tickets;
  int N, H, W, C, CO, flags;
  int TW, R, S;      // tile: S samples x R rows x TW columns
  int tiles_x, T;    // tiles per row of tiles, per sample
  int nch;           // 64-byte channel chunks
  int tma_x;         // 1: the input arrives by TMA
  int tma_res;       // 1: the residual tile arrives by TMA
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

// ---- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
// consumer warpgroups only: the producer warp never joins
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// ---- wgmma: both operands by matrix descriptor, K-major
// A: no swizzle, core matrices of 8 pixels x 16 bytes; consecutive 16-byte
// K planes are `lbo` bytes apart, consecutive 8-pixel rows `sbo` bytes
__device__ __forceinline__ uint64_t desc_a(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// B: 64-byte swizzle as TMA writes it, rows of 64 bytes, 8-row groups 512
// bytes apart (the leading offset is unused when swizzled)
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the accumulators where it stands: before the first group, their
// zeroing (nothing but wgmma may write them while a group is open, or ptxas
// serializes every wgmma); after the last wait, the epilogue's reads
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17,"
      " p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17,"
      " p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33,"
      " p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33,"
      " p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65,"
      " p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65,"
      " p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
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
__device__ __forceinline__ void split_tf32(float v, float& big, float& small) {
  uint32_t b, s;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(b) : "f"(v));
  big = __uint_as_float(b);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s) : "f"(v - big));
  small = __uint_as_float(s);
}

// Shared memory, in this order: the weight ring (1024-aligned stages), the
// raw input buffers (TMA only), the halo buffers, the residual tile (TMA
// only), the moment slices, the coefficients and the mbarriers.  HP = S *
// (R + 2) * (TW + 2) halo pixels; NB = min(chunks, 2) buffers of each kind.  A halo buffer is 4 planes of 16 bytes a pixel (8
// bf16 or 4 fp32 channels), and fp32 adds 4 planes of the TF32 small halves;
// a plane's stride is 32 bytes past a multiple of 128, so that the 8
// threads of a 16-byte store phase, 2 pixels x 4 planes, hit distinct banks.
template <typename T, int BN, int BM>
struct Layout {
  // a pipeline step is TPS taps of one chunk: bf16 a kernel row (3 taps, 6
  // wgmma a row block), fp32 one tap (6 TF32 wgmma); DEPTH groups stay in
  // flight past each wait
  static constexpr int TPS = sizeof(T) == 2 ? 3 : 1;
  static constexpr int DEPTH = sizeof(T) == 2 ? 1 : 2;
  static constexpr int WTILE = BN * KBYTES;   // one tap's 64 bytes x BN
  static constexpr int WHALF = TPS * WTILE;   // fp32: then the small halves
  static constexpr int WSTAGE = (sizeof(T) == 2 ? 1 : 2) * WHALF;
  static constexpr int RING = CONV3X3_GN_RING_BYTES;
  static constexpr int STAGES =  // weight ring depth: about 48 KB
      RING / WSTAGE > 8 ? 8 : (RING / WSTAGE < DEPTH + 2 ? DEPTH + 2
                                                        : RING / WSTAGE);
  static constexpr int PLANES = sizeof(T) == 2 ? 4 : 8;
  static constexpr int RED = 2 * (BM / 16) * BN * 4;
  static constexpr int BARS = (2 * STAGES + 5) * 8 + 16;
  static __host__ __device__ int raw_bytes(int hp) {
    return (hp * KBYTES + 127) / 128 * 128;
  }
  static __host__ __device__ int plane(int hp) {
    return (hp * 16 + 127) / 128 * 128 + 32;
  }
  static __host__ __device__ int halo_bytes(int hp) {
    return (PLANES * plane(hp) + 127) / 128 * 128;
  }
  struct Offsets {
    int raw, halo, res, red, coef, bars, total;
  };
  // cpad: channels in whole chunks; the coefficient block holds a and b'
  // (S x cpad each), the bias (BN) and the sample bias (S x BN)
  static __host__ __device__ Offsets offsets(int hp, int tma, int nb,
                                             int stages, int S, int cpad,
                                             int tma_res) {
    Offsets o;
    o.raw = stages * WSTAGE;
    o.halo = o.raw + (tma ? nb * raw_bytes(hp) : 0);
    o.res = o.halo + nb * halo_bytes(hp);
    o.red = o.res + (tma_res ? (BM * BN * (int)sizeof(T) + 127) / 128 * 128
                             : 0);
    o.coef = o.red + RED;
    o.bars = o.coef + ((2 * S * cpad + BN + S * BN) * 4 + 15) / 16 * 16;
    o.total = o.bars + BARS + 1024;  // + slack to align the base
    return o;
  }
};

// blocks an SM must hold: the small tiles are latency-bound, not tensor-bound
template <int BN, int NWG, int MW>
constexpr int min_blocks() {
  return BN * MW > 64 ? 1 : (NWG == 1 ? 3 : 2);
}

template <typename T, int BN, int NWG, int MW>
__global__ void __launch_bounds__(128 * NWG + 32, min_blocks<BN, NWG, MW>())
conv3x3_gn_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap rmap, const Params p) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int BM = 64 * NWG * MW;
  constexpr int CT = 128 * NWG;            // consumer threads
  constexpr int VEC = 16 / sizeof(T);      // elements per 16 bytes
  constexpr int KCH = KBYTES / sizeof(T);  // channels per chunk
  constexpr int ND = BN / 2;               // accumulators per m64 row block
  using L = Layout<T, BN, BM>;
  constexpr int STAGES = L::STAGES, TPS = L::TPS, SPC = 9 / L::TPS;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int TW = p.TW, R = p.R, S = p.S, HW2 = TW + 2;
  const int SLAB = (R + 2) * HW2;          // halo pixels of one sample
  const int HP = S * SLAB;
  const int nch = p.nch, steps = SPC * nch, NB = nch > 1 ? 2 : 1;
  // the ring holds no more stages than the call has steps
  const int stages = steps < STAGES ? steps : STAGES;
  const int tma_x = p.tma_x, tma_res = p.tma_res, cpad = nch * KCH;
  const auto off = L::offsets(HP, tma_x, NB, stages, S, cpad, tma_res);
  uint8_t* wring = smem;
  uint8_t* raw = smem + off.raw;
  uint8_t* halo = smem + off.halo;
  const T* res_s = (const T*)(smem + off.res);
  float* red = (float*)(smem + off.red);
  float* coef_a = (float*)(smem + off.coef);  // [S][cpad]
  float* coef_b = coef_a + S * cpad;          // [S][cpad]
  float* bias_s = coef_b + S * cpad;          // [BN]
  float* sbias_s = bias_s + BN;               // [S][BN]
  uint64_t* bars = (uint64_t*)(smem + off.bars);
  int* flag = (int*)(bars + 2 * STAGES + 5);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * STAGES;
  const uint32_t rawfull0 = empty0 + 8 * STAGES, rawempty0 = rawfull0 + 16;
  const uint32_t resfull = rawempty0 + 16;
  const int RAWB = L::raw_bytes(HP), PL = L::plane(HP);
  const int HALB = L::halo_bytes(HP);

  const int H = p.H, W = p.W, C = p.C, CO = p.CO, N = p.N;
  const int co_tiles = CO / BN;
  const int ct = blockIdx.x % co_tiles, co0 = ct * BN;
  const int ptile = blockIdx.x / co_tiles;
  const int grp = ptile / p.T, tile = ptile - grp * p.T;
  const int n0 = grp * S;
  const int y0 = (tile / p.tiles_x) * R, x0 = (tile % p.tiles_x) * TW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * NWG);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(rawfull0 + 8 * i, 1);
      mbar_init(rawempty0 + 8 * i, 1);
    }
    mbar_init(resfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---------------------------------------------------------- producer warp
  if (warp == 4 * NWG) {
    if (lane == 0) {
      const uint32_t wring_a = smem_u32(wring), raw_a = smem_u32(raw);
      auto load_raw = [&](int ci) {
        const int b = ci & 1;
        if (ci >= 2) mbar_wait(rawempty0 + 8 * b, ((ci >> 1) - 1) & 1);
        mbar_expect_tx(rawfull0 + 8 * b, (uint32_t)(HP * KBYTES));
        tma_load_4d(raw_a + b * RAWB, &xmap, rawfull0 + 8 * b, ci * KCH,
                    x0 - 1, y0 - 1, n0);
      };
      if (tma_x) {
        load_raw(0);
        if (nch > 1) load_raw(1);
      }
      if (tma_res) {  // the residual tile, read by the epilogue
        mbar_expect_tx(resfull, (uint32_t)(BM * BN * sizeof(T)));
        tma_load_4d(smem_u32(res_s), &rmap, resfull, co0, x0, y0, n0);
      }
      for (int s = 0; s < steps; ++s) {
        const int st = s % stages;
        if (s >= stages) mbar_wait(empty0 + 8 * st, ((s / stages) - 1) & 1);
#ifdef CONV3X3_GN_WEIGHTS_ONCE
        if (s >= stages) mbar_arrive(full0 + 8 * st); else
#endif
        {
          mbar_expect_tx(full0 + 8 * st, (uint32_t)L::WSTAGE);
#pragma unroll
          for (int k = 0; k < TPS; ++k) {  // K steps s * TPS + k, one a tap
            const uint32_t dst = wring_a + st * L::WSTAGE + k * L::WTILE;
            tma_load_2d(dst, &wmap, full0 + 8 * st, (s * TPS + k) * KCH, co0);
            if constexpr (!BF16)
              tma_load_2d(dst + L::WHALF, &wmap, full0 + 8 * st,
                          (s * TPS + k) * KCH, CO + co0);
          }
        }
        // chunk c + 2 once chunk c's weights are out, into the buffer the
        // consumers freed when they staged chunk c
        if (tma_x && s % SPC == SPC - 1 && s / SPC + 2 < nch)
          load_raw(s / SPC + 2);
      }
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroups
  const int wg = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int SLABPX = R * TW;  // output pixels of one sample in the tile
  const int RB = R / 8, NCG = TW / 8;
  const bool prologue = p.flags & HAS_PROLOGUE;
  const T* x = (const T*)p.x;
  const uint32_t halo_a = smem_u32(halo), wring_a = smem_u32(wring);

  // raw chunk (or, without TMA, global memory) -> halo buffer ci & 1:
  // prologue, rounding to T, zero outside the image and past C, written as
  // 16-byte planes (fp32: TF32 big and small halves).  A thread keeps one
  // 16-byte vector j of every CT / 4-th pixel, U pixels a pass with their
  // loads before their stores, and walks (sample, row, column) without
  // dividing.
  auto stage_halo = [&](int ci) {
    constexpr int U = 2, PSTEP = CT / 4;
    const uint8_t* rb = raw + (ci & 1) * RAWB;
    uint8_t* hb = halo + (ci & 1) * HALB;
    const int j = tid & 3, cb = ci * KCH + j * VEC;
    int px = tid >> 2;
    int sm = px / SLAB, hy = (px - sm * SLAB) / HW2;
    int hx = px - sm * SLAB - hy * HW2;
    const int qy = PSTEP / HW2, qx = PSTEP - qy * HW2;
    float a[VEC], b[VEC];
    auto coeffs = [&](int smp) {  // sample smp's, from shared memory
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        a[e] = coef_a[smp * cpad + cb + e];
        b[e] = coef_b[smp * cpad + cb + e];
      }
    };
    int s_cur = sm;
    coeffs(sm);
    const bool all_c = cb + VEC <= C;  // this thread's channels all below C
    if (tma_x) mbar_wait(rawfull0 + 8 * (ci & 1), (ci >> 1) & 1);
    while (px < HP) {
      uint4 in[U];
      int pos[U], smp[U];
      bool inside[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int n = n0 + sm, yy = y0 - 1 + hy, xx = x0 - 1 + hx;
        pos[u] = px < HP ? px : -1;
        smp[u] = sm;
        inside[u] = px < HP && n < N && yy >= 0 && yy < H && xx >= 0 &&
                    xx < W;
        in[u] = make_uint4(0, 0, 0, 0);
        if (inside[u]) {
          if (tma_x) {
            in[u] = *(const uint4*)(rb + px * KBYTES + j * 16);
          } else {
            const T* src = x + (((size_t)n * H + yy) * W + xx) * C;
            __align__(16) T e8[VEC];
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              e8[e] = cb + e < C ? src[cb + e] : from_f<T>(0.f);
            in[u] = *(const uint4*)e8;
          }
        }
        px += PSTEP;
        hx += qx;
        hy += qy;
        if (hx >= HW2) {
          hx -= HW2;
          ++hy;
        }
        while (hy >= R + 2) {
          hy -= R + 2;
          ++sm;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (pos[u] < 0) continue;
        if (smp[u] != s_cur) {  // a new sample: at most S - 1 times
          s_cur = smp[u];
          coeffs(s_cur);
        }
        const bool full = inside[u] && all_c;
        uint8_t* dst = hb + j * PL + pos[u] * 16;
        if (BF16 && !prologue && full) {  // the values as they are
          *(uint4*)dst = in[u];
          continue;
        }
        __align__(16) T v8[VEC];
        *(uint4*)v8 = in[u];
        float v[VEC];
        if (full && prologue) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            v[e] = swish<BF16>(fmaf(to_f(v8[e]), a[e], b[e]));
        } else if (full) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = to_f(v8[e]);
        } else {  // past C, or a halo pixel outside the data: zero
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            v[e] = 0.f;
            if (inside[u] && cb + e < C) {
              v[e] = to_f(v8[e]);
              if (prologue) v[e] = swish<BF16>(v[e] * a[e] + b[e]);
            }
          }
        }
        if constexpr (BF16) {
          __align__(16) T out[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) out[e] = from_f<T>(v[e]);
          *(uint4*)dst = *(const uint4*)out;
        } else {
          float4 big, small;
          split_tf32(v[0], big.x, small.x);
          split_tf32(v[1], big.y, small.y);
          split_tf32(v[2], big.z, small.z);
          split_tf32(v[3], big.w, small.w);
          *(float4*)dst = big;
          *(float4*)(dst + 4 * PL) = small;
        }
      }
    }
    // the generic-proxy writes, before wgmma (the async proxy) reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // tap (0, 0) of each m64 row block of this warpgroup, as a byte offset in
  // a plane: the block is 8 image rows x 8 columns of one sample, so its 8
  // core matrices (8 pixels of a row each) are one halo row apart
  uint32_t a_off[MW];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) {
    const int q = wg * MW + mw;
    const int s = q / (NCG * RB), rem = q - s * (NCG * RB);
    const int cg = rem / RB, r0 = (rem - cg * RB) * 8;
    a_off[mw] = (s * SLAB + r0 * HW2 + cg * 8) * 16;
  }

  // the prologue's coefficients of every chunk, the bias and the sample
  // bias, fetched once while the first TMA loads are in flight
  for (int i = tid; i < S * cpad; i += CT) {
    const int sm = i / cpad, c = i - sm * cpad, n = n0 + sm;
    const bool on = prologue && c < C && n < N;
    coef_a[i] = on ? __ldg(p.pa + (size_t)n * C + c) : 1.f;
    coef_b[i] = on ? __ldg(p.pb + (size_t)n * C + c) : 0.f;
  }
  for (int i = tid; i < BN; i += CT) bias_s[i] = __ldg(p.bias + co0 + i);
  for (int i = tid; i < S * BN; i += CT) {
    const int sm = i / BN, n = n0 + sm;
    sbias_s[i] = (p.flags & HAS_SAMPLE_BIAS) && n < N
                     ? __ldg(p.sb + (size_t)n * CO + co0 + (i - sm * BN))
                     : 0.f;
  }
  consumer_sync(CT);

  float acc[MW][ND];
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) {
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[mw][e] = 0.f;
    fence_operand(acc[mw]);  // defined here, before any wgmma group opens
  }

  // both buffers are free: the first two chunks before the products
  stage_halo(0);
  if (nch > 1) stage_halo(1);
  consumer_sync(CT);
  if (tma_x && tid == 0) {
    mbar_arrive(rawempty0);
    if (nch > 1) mbar_arrive(rawempty0 + 8);
  }

  const uint32_t sbo = HW2 * 16;
  for (int s = 0; s < steps; ++s) {
    const int ci = s / SPC, k0 = (s - ci * SPC) * TPS;  // first tap
    const int st = s % stages;
    mbar_wait(full0 + 8 * st, (s / stages) & 1);
    const uint32_t hb = halo_a + (ci & 1) * HALB;
    const uint32_t wb = wring_a + st * L::WSTAGE;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < TPS; ++k) {
      const int tap = k0 + k, ky = tap / 3, kx = tap - ky * 3;
      const uint32_t ha = hb + (ky * HW2 + kx) * 16;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {  // 32 bytes of K: two 16-byte planes
        const uint64_t db = desc_b(wb + k * L::WTILE + ks * 32);
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) {
          const uint64_t da = desc_a(ha + 2 * ks * PL + a_off[mw], PL, sbo);
          if constexpr (BF16) {
            wgmma_bf16(acc[mw], da, db);
          } else {
            const uint64_t da_small =
                desc_a(ha + (4 + 2 * ks) * PL + a_off[mw], PL, sbo);
            const uint64_t db_small =
                desc_b(wb + L::WHALF + k * L::WTILE + ks * 32);
            wgmma_tf32(acc[mw], da_small, db);
            wgmma_tf32(acc[mw], da, db_small);
            wgmma_tf32(acc[mw], da, db);
          }
        }
      }
    }
    wgmma_commit();
    wgmma_wait<L::DEPTH>();  // groups up to s - DEPTH are done: free a stage
    if (s >= L::DEPTH && lane == 0)
      mbar_arrive(empty0 + 8 * ((s - L::DEPTH) % stages));
    // mid-chunk, chunk ci - 1's products are done in this warpgroup; once
    // they are in every warpgroup (the barrier: a thread stages pixels that
    // another warpgroup's rows read), stage chunk ci + 1 into that buffer
    // while this chunk's groups run
    if (s - ci * SPC == SPC / 2 && ci >= 1 && ci + 1 < nch) {
      consumer_sync(CT);
      stage_halo(ci + 1);
      consumer_sync(CT);
      if (tma_x && tid == 0) mbar_arrive(rawempty0 + 8 * ((ci + 1) & 1));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) fence_operand(acc[mw]);

  // ---- epilogue: + bias (+ sample bias) (+ residual), cast, store, moments
  const T* res = (const T*)p.res;
  T* y = (T*)p.y;
  const bool emit = p.flags & EMIT_MOMENTS;
  if (tma_res) mbar_wait(resfull, 0);
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) {
    const int q = wg * MW + mw;  // m64 row block of the tile
    const int s = q / (NCG * RB), rem = q - s * (NCG * RB);
    const int cg = rem / RB, r0 = (rem - cg * RB) * 8;
    const int n = n0 + s;
    float msum[ND / 2], msq[ND / 2];
#pragma unroll
    for (int e = 0; e < ND / 2; ++e) msum[e] = msq[e] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // accumulator row w4 * 16 + half * 8 + g: image row 2 * w4 + half of
      // the block, column g
      const int yy = y0 + r0 + 2 * w4 + half, xx = x0 + cg * 8 + g;
      if (n >= N || yy >= H || xx >= W) continue;
      const size_t row = (((size_t)n * H + yy) * W + xx) * CO + co0 + 2 * t;
      // every load of the row before its stores
      float v[BN / 4];
      const int rs = ((s * R + r0 + 2 * w4 + half) * TW + cg * 8 + g) * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + 2 * t;
        v[2 * j] = acc[mw][4 * j + 2 * half] + bias_s[col] +
                   sbias_s[s * BN + col];
        v[2 * j + 1] = acc[mw][4 * j + 2 * half + 1] + bias_s[col + 1] +
                       sbias_s[s * BN + col + 1];
        if (p.flags & HAS_RESIDUAL) {
          float r0f, r1f;
          if constexpr (BF16) {
            const __nv_bfloat162 r2 =
                tma_res ? *(const __nv_bfloat162*)(res_s + rs + col)
                        : __ldg((const __nv_bfloat162*)(res + row + j * 8));
            r0f = __bfloat162float(r2.x);
            r1f = __bfloat162float(r2.y);
          } else {
            const float2 r2 = tma_res
                                  ? *(const float2*)(res_s + rs + col)
                                  : __ldg((const float2*)(res + row + j * 8));
            r0f = r2.x;
            r1f = r2.y;
          }
          v[2 * j] += r0f;
          v[2 * j + 1] += r1f;
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const T o0 = from_f<T>(v[2 * j]), o1 = from_f<T>(v[2 * j + 1]);
        if constexpr (BF16) {
          __nv_bfloat162 pr;
          pr.x = o0;
          pr.y = o1;
          *(__nv_bfloat162*)(y + row + j * 8) = pr;
        } else {
          *(float2*)(y + row + j * 8) = make_float2(o0, o1);
        }
        const float f0 = to_f(o0), f1 = to_f(o1);
        msum[2 * j] += f0;
        msq[2 * j] += f0 * f0;
        msum[2 * j + 1] += f1;
        msq[2 * j + 1] += f1 * f1;
      }
    }
    if (emit) {
#pragma unroll
      for (int e = 0; e < ND / 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          msum[e] += __shfl_xor_sync(0xffffffffu, msum[e], off);
          msq[e] += __shfl_xor_sync(0xffffffffu, msq[e], off);
        }
      if (lane < 4) {
        const int slice = q * 4 + w4;  // 16-row slice of the tile
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int col = j * 8 + 2 * lane + k;
            red[(0 * (BM / 16) + slice) * BN + col] = msum[2 * j + k];
            red[(1 * (BM / 16) + slice) * BN + col] = msq[2 * j + k];
          }
      }
    }
  }
  if (!emit) return;
  consumer_sync(CT);
  // this tile's partial per sample: its 16-row slices in order
  const int per = SLABPX / 16;  // slices of one sample
  for (int i = tid; i < S * 2 * BN; i += CT) {
    const int s = i / (2 * BN), k = (i / BN) & 1, col = i % BN;
    const int n = n0 + s;
    if (n >= N) continue;
    float v = 0.f;
    for (int sl = s * per; sl < (s + 1) * per; ++sl)
      v += red[(k * (BM / 16) + sl) * BN + col];
    if (p.T == 1) {  // the sample's only tile: its moments
      p.mom[((size_t)n * 2 + k) * CO + co0 + col] = v;
      continue;
    }
    p.ws[(((size_t)n * p.T + tile) * 2 + k) * CO + co0 + col] = v;
  }
  if (p.T == 1) return;
  consumer_sync(CT);
  // the barrier, then one device-scope fence, order every thread's partials
  // before the ticket (the fence is cumulative)
  int* ticket = p.tickets + (size_t)grp * co_tiles + ct;
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(ticket, 1) == p.T - 1;
  }
  consumer_sync(CT);
  if (!*flag) return;
  // the last block of this (sample group, channel slice): the T partials
  // of each sample in tile order
  __threadfence();
  for (int i = tid; i < S * 2 * BN; i += CT) {
    const int s = i / (2 * BN), k = (i / BN) & 1, col = i % BN;
    const int n = n0 + s;
    if (n >= N) continue;
    const float* src = p.ws + ((size_t)n * p.T * 2 + k) * CO + co0 + col;
    float v = 0.f;
    for (int tt = 0; tt < p.T; ++tt) v += __ldcg(src + (size_t)tt * 2 * CO);
    p.mom[((size_t)n * 2 + k) * CO + co0 + col] = v;
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch on this stream
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)ptr;
  }
  return fn;
}

// per_sm: instead of launching, the blocks an SM holds and the dynamic
// shared memory of a block
template <typename T, int BN, int NWG, int MW>
int launch_tile(Params p, const CUtensorMap& wmap, const CUtensorMap& xmap,
                const CUtensorMap& rmap, cudaStream_t stream, int* per_sm) {
  using L = Layout<T, BN, 64 * NWG * MW>;
  const int hp = p.S * (p.R + 2) * (p.TW + 2);
  const int steps = p.nch * 3 * (3 / L::TPS);
  const int stages = steps < L::STAGES ? steps : L::STAGES;
  const int cpad = p.nch * (KBYTES / (int)sizeof(T));
  auto bytes = [&]() {
    return (size_t)L::offsets(hp, p.tma_x, p.nch > 1 ? 2 : 1, stages, p.S,
                              cpad, p.tma_res).total;
  };
  if (p.tma_res && bytes() > MAX_SMEM) p.tma_res = 0;  // residual: global
  const size_t smem = bytes();
  if (smem > MAX_SMEM) return -1;
  // an attribute of the current device's context: set on every launch, so
  // that each card has it
  const cudaError_t e = cudaFuncSetAttribute(
      conv3x3_gn_kernel<T, BN, NWG, MW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (per_sm) {
    per_sm[1] = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, conv3x3_gn_kernel<T, BN, NWG, MW>, 128 * NWG + 32, smem);
  }
  const long long groups = (p.N + p.S - 1) / p.S;
  const long long blocks = groups * p.T * (p.CO / BN);
  if (blocks >= (1LL << 31)) return -1;
  conv3x3_gn_kernel<T, BN, NWG, MW>
      <<<(unsigned)blocks, 128 * NWG + 32, smem, stream>>>(wmap, xmap, rmap,
                                                           p);
  return 0;
}

// (bm, bn) -> (BN, consumer warpgroups, m64 row blocks per warpgroup)
template <typename T>
int launch(const Params& p, int bm, int bn, const CUtensorMap& wmap,
           const CUtensorMap& xmap, const CUtensorMap& rmap,
           cudaStream_t stream, int* per_sm) {
#define CONV_TILE(BM_, BN_, NWG_, MW_)                                   \
  if (bm == BM_ && bn == BN_)                                            \
    return launch_tile<T, BN_, NWG_, MW_>(p, wmap, xmap, rmap, stream,  \
                                          per_sm);
  CONV_TILE(64, 32, 1, 1)
  CONV_TILE(128, 32, 2, 1)
  CONV_TILE(128, 64, 2, 1)
  CONV_TILE(128, 128, 2, 1)
  CONV_TILE(256, 32, 2, 2)
  CONV_TILE(256, 64, 2, 2)
#undef CONV_TILE
  return -1;
}

// conv3x3_gn_launch's body; per_sm: see launch_tile
int run(int dtype, const void* x, const void* wp, const void* bias,
        const void* pa, const void* pb, const void* sb, const void* res,
        void* y, void* mom, void* ws, void* tickets, int N, int H, int W,
        int C, int CO, int flags, int bm, int bn, int tw, int rows,
        void* stream, int* per_sm) {
  if (dtype != 0 && dtype != 1) return -1;
  const int item = dtype == 0 ? 4 : 2;
  if (N < 1 || H < 1 || W < 1 || C < 1 || CO < 1 || bn < 1 || CO % bn != 0 ||
      tw < 8 || rows < 8 || tw % 8 != 0 || rows % 8 != 0 ||
      bm % (rows * tw) != 0 ||
      bm / (rows * tw) > MAX_S || ((uintptr_t)wp & 15) != 0)
    return -1;
  EncodeTiled encode = encode_tiled();
  if (!encode) return -1;
  const int kch = KBYTES / item;
  Params p{x, (const float*)bias, (const float*)pa, (const float*)pb,
           (const float*)sb, res, y, (float*)ws, (float*)mom, (int*)tickets,
           N, H, W, C, CO, flags, tw, rows, bm / (rows * tw), 0, 0, 0, 0, 0};
  p.tiles_x = (W + tw - 1) / tw;
  p.T = ((H + rows - 1) / rows) * p.tiles_x;
  p.nch = (C + kch - 1) / kch;
  const CUtensorMapDataType type = dtype == 0
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap wmap, xmap;
  {
    const cuuint64_t kp = (cuuint64_t)p.nch * 9 * kch;
    const cuuint64_t dims[2] = {kp, (cuuint64_t)CO * (dtype == 0 ? 2 : 1)};
    const cuuint64_t strides[1] = {kp * item};
    const cuuint32_t box[2] = {(cuuint32_t)kch, (cuuint32_t)bn};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&wmap, type, 2, (void*)wp, dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return -1;
  }
  // the input by TMA: rows of whole 16-byte vectors, at least one chunk of
  // channels, and a box that fits the map's 256-element limit
  xmap = wmap;
  p.tma_x = (C * item) % 16 == 0 && C >= kch &&
            ((uintptr_t)x & 15) == 0 && tw + 2 <= 256 && rows + 2 <= 256;
  if (p.tma_x) {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)C * item,
                                   (cuuint64_t)W * C * item,
                                   (cuuint64_t)H * W * C * item};
    const cuuint32_t box[4] = {(cuuint32_t)kch, (cuuint32_t)(tw + 2),
                               (cuuint32_t)(rows + 2), (cuuint32_t)p.S};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    // a map cuTensorMapEncodeTiled refuses leaves the loads to global memory
    p.tma_x = encode(&xmap, type, 4, (void*)x, dims, strides, box, estr,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  // the residual tile by TMA: a box of (bn, tw, rows, samples) at (co0, x0,
  // y0, n0), zero past the data
  CUtensorMap rmap = wmap;
  if (res != nullptr && ((uintptr_t)res & 15) == 0) {
    const cuuint64_t dims[4] = {(cuuint64_t)CO, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)CO * item,
                                   (cuuint64_t)W * CO * item,
                                   (cuuint64_t)H * W * CO * item};
    const cuuint32_t box[4] = {(cuuint32_t)bn, (cuuint32_t)tw,
                               (cuuint32_t)rows, (cuuint32_t)p.S};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    p.tma_res = (flags & HAS_RESIDUAL) &&
                encode(&rmap, type, 4, (void*)res, dims, strides, box, estr,
                       CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_NONE,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  cudaStream_t s = (cudaStream_t)stream;
  int err = -1;
  if (dtype == 0) err = launch<float>(p, bm, bn, wmap, xmap, rmap, s, per_sm);
  if (dtype == 1)
    err = launch<__nv_bfloat16>(p, bm, bn, wmap, xmap, rmap, s, per_sm);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  wp: the packed weights, (CO, K) rows
// (float32: (2*CO, K), the TF32 big halves then the small ones) with
// K = nch * 9 * (64 bytes of channels) in the order (chunk, tap, channel),
// zero past C.  (bm, bn, tw, rows): the block's tile, bm pixels as
// bm / (rows * tw) samples of rows x tw pixels (rows * tw a multiple of
// 64), by bn output channels, as the wrapper's launch plan picks them.
// ws: the (N, T, 2, CO) fp32 partial-moment workspace, T = ceil(H / rows) *
// ceil(W / tw); tickets: ceil(N / samples) * (CO / bn) ints, zero on entry
// and left zero.  Both only when moments are asked.  Returns a cudaError_t
// (0 on success), or -1 for arguments the kernel does not take.
extern "C" int conv3x3_gn_launch(int dtype, const void* x, const void* wp,
                                 const void* bias, const void* pa,
                                 const void* pb, const void* sb,
                                 const void* res, void* y, void* mom,
                                 void* ws, void* tickets, int N, int H, int W,
                                 int C, int CO, int flags, int bm, int bn,
                                 int tw, int rows, void* stream) {
  return run(dtype, x, wp, bias, pa, pb, sb, res, y, mom, ws, tickets, N, H,
             W, C, CO, flags, bm, bn, tw, rows, stream, nullptr);
}

// The same arguments, launching nothing: out[0] = the blocks an SM holds,
// out[1] = a block's dynamic shared memory in bytes (for measurements).
extern "C" int conv3x3_gn_occupancy(int dtype, const void* x, const void* wp,
                                    const void* bias, const void* pa,
                                    const void* pb, const void* sb,
                                    const void* res, void* y, void* mom,
                                    void* ws, void* tickets, int N, int H,
                                    int W, int C, int CO, int flags, int bm,
                                    int bn, int tw, int rows, void* stream,
                                    int* out) {
  return run(dtype, x, wp, bias, pa, pb, sb, res, y, mom, ws, tickets, N, H,
             W, C, CO, flags, bm, bn, tw, rows, stream, out);
}
