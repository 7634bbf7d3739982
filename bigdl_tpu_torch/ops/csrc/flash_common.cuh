// What the flash-attention kernels share: tile sizes, the mma.sync /
// ldmatrix / cp.async wrappers of the bf16 path, the tile loads and the
// FMA matrix products of the f32 path, and the launch helper.
//
// Included by flash_fwd.cu and flash_bwd.cu, each built into its own
// shared library (ops/_build.py hashes this header with each source).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int NTHREADS = 128;  // 4 warps; warp w owns rows 16w..16w+15
constexpr float NEG_INF = -1e30f;  // the finite mask value of the TPU kernels
constexpr unsigned FULL = 0xffffffffu;
// exp(x) as exp2(x log2 e): one MUFU.EX2 instead of expf's range-reduced
// sequence. Used in the bf16 paths only, where P is rounded to bf16
// anyway; the f32 paths keep expf to stay close to the f32 plain version.
constexpr float LOG2E = 1.4426950408889634f;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// is key `col` visible to query `row` by position? q_offset = s_k - s_q
// (bottom-right causal); the segment compare is the caller's
__device__ __forceinline__ bool live(int col, int row, int Sk, int q_offset,
                                     int causal) {
  return col < Sk && (!causal || col <= q_offset + row);
}

// ================================================================== f32
template <int D> struct F32 {
  static constexpr int LDT = D + 4;   // Q, K, V, dO rows (floats; 16-byte pad)
  static constexpr int LDS = BK + 4;  // S / dP rows
  static constexpr int LDO = D + 4;   // accumulator rows
};

// rows [row0, row0+64) of a (rows, D) matrix into shared memory, 16 bytes a
// thread; rows at or past n_rows are zero so masked entries meet finite values
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int n_rows,
                                              long long row_stride) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < BQ * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const float4*>(
          src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * F32<D>::LDT + c) = val;
  }
}

// C (64 x 64, row stride LDS) = A (64 x D) B (64 x D)^T * scale, both
// operands row-major in shared memory with row stride LDT. Thread (ty, tx)
// computes rows 8ty..8ty+7 and columns tx + 16j, so warp w owns rows
// 16w..16w+15.
template <int D>
__device__ __forceinline__ void mm_nt_f32(const float* As, const float* Bs,
                                          float* Cs, float scale) {
  using L = F32<D>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty * 8 + i) * L::LDT + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * L::LDT + kk);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Cs[(ty * 8 + i) * L::LDS + tx + 16 * j] = acc[i][j] * scale;
}

// acc (rows 8ty..8ty+7, columns tx + 16j of a 64 x D result) +=
// P (64 x 64, row stride LDS) V (64 x D, row stride LDT)
template <int D>
__device__ __forceinline__ void mm_acc_f32(const float* Ps, const float* Vs,
                                           float (&acc)[8][D / 16]) {
  using L = F32<D>;
  constexpr int NJ = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int kk = 0; kk < BK; kk += 4) {
    float4 pr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      pr[i] = *reinterpret_cast<const float4*>(Ps + (ty * 8 + i) * L::LDS + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[(kk + u) * L::LDT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pi = u == 0 ? pr[i].x : u == 1 ? pr[i].y
                       : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pi, vv[j], acc[i][j]);
      }
    }
  }
}

// the same, with the accumulator kept in shared memory (row stride LDO)
template <int D>
__device__ __forceinline__ void mm_acc_f32_smem(const float* Ps,
                                                const float* Vs, float* Os) {
  using L = F32<D>;
  constexpr int NJ = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc[i][j] = Os[(ty * 8 + i) * L::LDO + tx + 16 * j];
  mm_acc_f32<D>(Ps, Vs, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      Os[(ty * 8 + i) * L::LDO + tx + 16 * j] = acc[i][j];
}

// ================================================================= bf16
// mma.sync m16n8k16 fragments, lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, col-major):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16x8, f32):        c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// The low half of a 32-bit register holds the lower index. The C
// fragments of two adjacent n-blocks are exactly the A fragment of one
// 16-wide k-step, so a product's result feeds the next product from
// registers.

template <int D> struct BF16 {
  static constexpr int LDT = D + 8;  // rows padded by 16 bytes: the 8 rows
                                     // of a ldmatrix phase hit distinct banks
  static constexpr int TILE = BQ * LDT;  // elements of one 64-row tile
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of one k-step from the C fragments of n-blocks 2kk, 2kk+1
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i holds its fragment (row g, columns 2t, 2t+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed on the way to the registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Lane addresses into a 64-row tile (row stride LDT) for ldmatrix_x4:
// A fragment of rows r0..r0+15, k columns c0..c0+15 (a0..a3)
__device__ __forceinline__ int a_frag_offset(int lane, int LDT) {
  return (lane & 15) * LDT + (lane >> 4) * 8;
}
// B fragments of two n-blocks (rows r0..r0+15 as n), k columns c0..c0+15,
// from rows that lie as the B operand's columns (K for Q K^T): regs 0,1 =
// b0,b1 of rows r0..r0+7, regs 2,3 = b0,b1 of rows r0+8..r0+15
__device__ __forceinline__ int b_frag_offset(int lane, int LDT) {
  return ((lane >> 4) * 8 + (lane & 7)) * LDT + ((lane >> 3) & 1) * 8;
}
// with ldmatrix_x4_trans: B fragments over k = rows r0..r0+15, n = columns
// c0..c0+7 (regs 0,1) and c0+8..c0+15 (regs 2,3) (V for P V)
__device__ __forceinline__ int bt_frag_offset(int lane, int LDT) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * LDT + (lane >> 4) * 8;
}

// 16 bytes global -> shared, asynchronous; zero-filled when !ok
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool ok) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0+64) of a (rows, D) matrix into shared memory
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int row0, int n_rows,
                                               long long row_stride) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < BQ * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool ok = row0 + r < n_rows;  // past the end: zeros, row 0 read
    cp_async16(dst + r * BF16<D>::LDT + c,
               src + (long long)(ok ? row0 + r : 0) * row_stride + c, ok);
  }
}

// 64 per-row values (segment ids, lse, delta) of rows [row0, row0+64)
// into shared memory; `fill` past n_rows. Synchronous loads by the first
// 64 threads: visible to the block after its next __syncthreads.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int n_rows, T fill) {
  if (threadIdx.x < BQ) {
    const int r = row0 + threadIdx.x;
    dst[threadIdx.x] = r < n_rows ? src[r] : fill;
  }
}

// ------------------------------------------------------------ launching
// The shared-memory opt-in is set at a kernel's first launch only, so that
// later launches can be captured into a CUDA graph.
template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, size_t smem, std::atomic<bool>& opted_in,
                   const Params& p, dim3 grid, cudaStream_t stream) {
  if (!opted_in.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in.store(true);
  }
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// make `device` current for the launch
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

}  // namespace flash
