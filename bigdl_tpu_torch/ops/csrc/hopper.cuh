// Hopper (sm_90a) building blocks of the flash-attention kernels: mbarriers,
// TMA tensor-map loads, warpgroup matrix multiply (wgmma) on 128-byte
// swizzled shared-memory tiles, register hand-over between warpgroups, and
// the frame the forward and the backward share: persistent CTAs of two
// consumer warpgroups and a producer warpgroup, a unit's own tiles in two
// buffers, a ring of streamed tiles.
//
// Tile layout. A tile of R rows of D bf16 (D a multiple of 64) lies in
// shared memory as D/64 column blocks of R rows x 128 bytes, each written by
// one TMA box of 64 columns with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8), in atoms of 8 rows x 128
// bytes (1024 bytes, so every tile starts 1024-byte aligned). wgmma reads
// such a tile through a descriptor in two ways:
//   K-major (the product's depth runs along the row, as Q or K in Q K^T):
//     k-step kk (16 columns, 32 bytes) starts at column block kk / 4, byte
//     32 (kk % 4) of the row; 8-row groups 1024 bytes apart (SBO).
//   MN-major (the depth runs down the rows, as dO in P^T dO): k-step kk
//     (16 rows) starts at row 16 kk; 8-row groups 1024 bytes apart (SBO),
//     the next 64 columns one column block (R x 128 bytes) further (LBO).
//
// Included by flash_fwd.cu and flash_bwd.cu (ops/_build.py hashes every
// header with each source).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// make the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive, and expect `bytes` more of TMA transfers in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// expect `bytes` more of TMA transfers in the current phase (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that has
// not ended after 2^32 clocks (about 2 s) traps: a lost arrival fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 32)) {
      __trap();
    }
  }
}

// 4 bytes global -> shared, asynchronously (cp.async); zeros when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// arrive on `bar` (as one of its expected arrivals) once every cp.async
// this thread issued before has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ------------------------------------------------------------------- TMA
// one box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -------------------------------------------------------------- warpgroups
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -------------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that a running wgmma reads or writes: the compiler must not
// move their uses across the wait (the asm statements above name no
// registers), nor give an A fragment's registers to another value before
// the product that reads them has finished.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// descriptor of a 128-byte-swizzled operand at shared address `addr`
// (leading and stride byte offsets as in the note at the top)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// k-step kk of a K-major operand: `addr` is the operand's first row in
// column block 0 of a tile of `rows` rows
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int rows,
                                                int kk) {
  return sw128_desc(addr + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// k-step kk of an MN-major operand: a whole tile of `rows` rows at `addr`
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int rows,
                                                 int kk) {
  return sw128_desc(addr + kk * 16 * 128, rows * 128, 1024);
}

// Accumulator of a 64 x N product (N/2 floats a thread): warp w of the
// warpgroup, lane 4g + t, holds rows 16w + g (d[4j], d[4j+1]) and 16w + g
// + 8 (d[4j+2], d[4j+3]) at columns 8j + 2t, 8j + 2t + 1. A register A
// fragment of k-step kk is the same for rows 16w.., columns 16kk..: the
// accumulator's n-blocks 2kk and 2kk+1, packed to bf16 pairs.

// D (64 x 64 f32) = A (64 x 16) B (16 x 64) [+ D when acc], A and B from
// shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 128 f32) = A (64 x 16) B (16 x 128) [+ D when acc], A and B from
// shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 64 f32) += A (64 x 16, registers) B (16 x 64), B from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128 f32) += A (64 x 16, registers) B (16 x 128), B from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------- persistent warp-specialised CTAs
// A persistent CTA on each SM walks its share of the units (one 128-row
// tile of one (batch, head)). Two consumer warpgroups own 64 rows of a
// unit each. The first warp of a producer warpgroup TMA-loads each unit's
// own tiles into one of two buffers, a unit ahead, and streams the other
// side's tiles through a ring of shared-memory stages that runs on from
// unit to unit. setmaxnreg moves registers to the consumers: ptxas sizes a
// kernel that hands registers over by whole warpgroups, 168 a thread for
// __launch_bounds__(384, 1), and 2 x 128 x 240 + 128 x 24 = 384 x 168.
constexpr int WG = 128;          // threads of a warpgroup
constexpr int THREADS = 3 * WG;  // two consumer warpgroups, a producer
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;

// full/empty barriers of a ring of N stages, and of each own-tile buffer
template <int N>
struct Bars {
  static constexpr uint32_t bytes = (2 * N + 4) * 8;
  uint64_t *full, *empty, *own_full, *own_empty;
  __device__ __forceinline__ Bars(unsigned char* smem, uint32_t off)
      : full(reinterpret_cast<uint64_t*>(smem + off)),
        empty(full + N),
        own_full(empty + N),
        own_empty(own_full + 2) {}
};

// a kernel's tensor maps: its own tiles (a, b) and the streamed ones (c, e)
struct Maps {
  CUtensorMap a, b, c, e;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

// A stage is full when the producer warp's 32 lanes have arrived and its
// TMA bytes have landed, empty when every consumer warp (8) has arrived;
// an own-tile buffer is full when lane 0 has arrived and its bytes landed.
template <int N>
__device__ __forceinline__ void init_barriers(unsigned char* smem,
                                              uint32_t bar_off) {
  if (threadIdx.x == 0) {
    const Bars<N> bar(smem, bar_off);
    for (int s = 0; s < N; ++s) {
      mbar_init(&bar.full[s], 32);
      mbar_init(&bar.empty[s], 8);
    }
    for (int o = 0; o < 2; ++o) {
      mbar_init(&bar.own_full[o], 1);
      mbar_init(&bar.own_empty[o], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// Unit i of this CTA, or -1: the units are numbered heaviest first, and
// round r hands units rG .. rG + G - 1 to the G CTAs, every other round in
// reverse, so that each CTA's sum of work comes out about even.
__device__ __forceinline__ int nth_unit(int i, int n_units) {
  const int G = gridDim.x, c = blockIdx.x;
  const int u = i * G + ((i & 1) ? G - 1 - c : c);
  return u < n_units ? u : -1;
}

// rows [row, row + rows) of (batch b, head h) through `map`, D/64 boxes
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row, int h, int b,
                                         int rows) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(dst + c * rows * 128, map, bar, c * 64, row, h, b);
}

// a consumer warp is done with a stage or an own-tile buffer: lane 0
// arrives, by a predicated instruction and not a branch, so that it may sit
// between a wgmma and its wait (ptxas serializes every wgmma of a kernel
// that has a branch there)
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(threadIdx.x % 32)
      : "memory");
}

// 2^x in one MUFU.EX2; a result below 2^-126 flushes to 0 (exp2f's
// handling of subnormals costs more than the rest of an elementwise pass)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -------------------------------------------------------- host: tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda; null if the driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  });
  return fn;
}

// A 4-D map (d, s, h, b) over a bf16 tensor with element strides
// (ss, sh, sb) of (row, head, batch), the last dim contiguous; boxes of 64
// columns x `box_rows` rows, 128-byte swizzled, rows past `s` read as 0.
// A dimension of size 1 gets the packed stride (its stride is never used,
// and the driver checks every stride).
inline cudaError_t make_map_4d(CUtensorMap* map, const void* base, int d,
                               int s, int h, int b, long long ss,
                               long long sh, long long sb, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (s == 1) ss = d;
  if (h == 1) sh = ss * s;
  if (b == 1) sb = sh * h;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The first launch of a kernel of persistent CTAs: check that it was built
// with the registers setmaxnreg hands over (a consumer asking for more than
// the CTA holds would wait forever), opt in to `smem` bytes of shared
// memory, and read the SM count into `sms`. Later launches skip this, so
// that they can be captured into a CUDA graph.
template <typename Kernel>
inline cudaError_t prepare_persistent(Kernel kernel, size_t smem,
                                      std::atomic<int>& sms) {
  if (sms.load() != 0) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (attr.numRegs * THREADS < 2 * WG * CONSUMER_REGS + WG * PRODUCER_REGS)
    return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int device = 0, n = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  sms.store(n);
  return cudaSuccess;
}

}  // namespace hopper
