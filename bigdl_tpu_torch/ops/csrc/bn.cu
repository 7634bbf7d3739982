// Batch-norm kernels for Hopper (sm_90a), f32 and bf16 inputs, f32 sums.
//
// Replace the four Pallas TPU kernels of bigdl_tpu/ops/bn_kernel.py:
//
//   _stats_kernel   (bn_stats)      Σx, Σx² per channel
//   _bwd_kernel     (bn_bwd_stats)  Σdy, Σ(dy·x̂) per channel, x̂ = (x −
//                                   mean)·inv formed here from x (the JAX
//                                   kernel reads an f32 x̂)
//   _fba_fwd_kernel (bn_fwd_apply)  the stats, then
//                                   y = x·scale + (β − mean·scale) [ReLU]
//   _fba_bwd_kernel (bn_bwd_fused)  x̂ = (x − mean)·inv, dy masked where
//                                   x̂γ + β <= 0 [ReLU], Σdy, Σ(dy·x̂), then
//                                   dx = (dy − Σdy/n − x̂·Σ(dy·x̂)/n)·γ·inv
//
// over a (rows, C) array whose rows are C contiguous values (NHWC
// activations seen as 2-D). They compute what those kernels compute, with
// the JAX package's numerics: f32 accumulation whatever the input type,
// var = max(Σx²/n − mean², 0) (not Welford), x̂ rounded as (x − mean), then
// ·inv, y and dx computed in f32 and rounded once to the input type, the
// strict > 0 of the recomputed ReLU mask. Every rows >= 1 and C >= 1 is
// taken: channels past C are masked.
//
// What bounds them on an H100: a few operations per element against 2 or
// 4 bytes read, so HBM bandwidth. The floor is one read of each input
// (x; dy and x) and one write of each output (y; dx).
//
// The TPU grid walks rows serially inside one 128-channel block (a VMEM
// accumulator carried from one grid step to the next, and for
// _fba_fwd_kernel the block's rows kept in VMEM between the stats and the
// apply); at ResNet-50's C = 64..2048 that is 1..16 programs, far too few
// for 132 SMs. Here rows are split into P slabs as well as channels into
// blocks. A CTA of 256 threads has TX across channels (V channels a
// thread, 16 bytes at a time where C allows) and TY across rows.
//
// All four are one kernel, bn_coop_kernel<MODE, T, V, RELU>, launched once
// per call and nothing beside it: a cooperative launch of as many CTAs as
// the card holds at once (the occupancy API's CTAs per SM x SMs, asked for
// each instance, whose shared memory differs by mode), each owning one
// (channel block, slab); a CTA loops over several only when C has more
// blocks than that.
//   phase 0  Each thread streams its own rows of the operands (x; or dy
//       and x) into its own slots of shared memory with 16-byte cp.async,
//       RING rows ahead of the one it reduces (8 operand-rows in flight),
//       so no thread waits on another's copies. The first RESIDENT rows
//       keep their slots; later rows cycle through the RING slots. Σx and
//       Σx² (STATS, FWD), or Σdy and Σ(dy·x̂) with the ReLU mask
//       (BWD_STATS, BWD_FUSED), in f32 registers; a tree over TY; one
//       (2, C) partial per slab.
//   barrier  Grid-wide; then every CTA finalises a few channels, a warp a
//       channel, its lanes summing the P partials in a fixed order and a
//       butterfly of shuffles combining them: the sums, or for FWD the
//       mean and var.
//   phase 1 (FWD, BWD_FUSED)  A second barrier, then y = x·scale + shift
//       [ReLU] from the mean and var, or dx: first the rows still in
//       shared memory (the last RING of the sweep, then the RESIDENT
//       ones), then the rest of the slab read backwards, so what phase 0
//       read last, most likely still in the 50 MB L2, is read first.
//       16-byte stores. FWD keeps 24 rows a thread (96 KB a CTA, two CTAs
//       an SM): at 264 CTAs an x of up to ~26 MB (ResNet-50's 100352 x
//       128, 25088 x 512 and 6272 x 2048 in bf16, and the smaller ones)
//       is read from device memory once.
// The barrier's two counters (arrivals, generation) are kept per (device,
// stream) by the caller and shared by the four modes: the arrivals are
// zero at the start and the last CTA to arrive resets them, so nothing is
// zeroed between launches. A wait that has not ended after ~2 s traps
// instead of hanging the card.
//
// No float atomics, and every sum is taken in an order fixed by the launch
// plan (rows, C, dtype, alignment and the card's SM count), so a result is
// the same from run to run. Elementwise arithmetic avoids FMA contraction
// (__fmul_rn, __fadd_rn) so it rounds as the plain PyTorch version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;
constexpr int MAXV = 8;  // channels a thread loads at once (16 bytes of bf16)

// bn_stats, bn_fwd_apply, bn_bwd_stats, bn_bwd_fused
enum Mode : int { STATS = 0, FWD = 1, BWD_STATS = 2, BWD_FUSED = 3 };

// What a mode streams and keeps in shared memory: OPS operands of 16 bytes
// a thread a row; SLOTS rows of them a thread, RING of them cycling, the
// rest holding the first rows of its slab for phase 1. FWD's 96 KB and the
// backward's 88 KB leave two CTAs an SM beside the static `red` (16 KB);
// STATS keeps no row.
template <int MODE>
struct Layout {
  static constexpr int OPS = MODE >= BWD_STATS ? 2 : 1;  // x; or dy, x
  static constexpr int RING = 8 / OPS;
  static constexpr int SLOTS = MODE == STATS ? RING : MODE == FWD ? 24 : 11;
  static constexpr int RESIDENT = SLOTS - RING;
  static constexpr bool EMITS = MODE == FWD || MODE == BWD_FUSED;
  static constexpr size_t SMEM = (size_t)SLOTS * OPS * 16 * NTHREADS;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Pack<T, V> k = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(k.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Pack<T, V> k;
#pragma unroll
  for (int i = 0; i < V; ++i) k.v[i] = from_f<T>(in[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = k;
}

// Sum red[k][ty][j] over ty into red[k][0][j], a fixed tree; every thread
// of the block calls it.
template <int V>
__device__ __forceinline__ void tree_reduce(float (*red)[NTHREADS * MAXV],
                                            int tx, int ty, int TX, int TY) {
  const int w = TX * V;
  for (int s = TY / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (ty < s) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[0][ty * w + tx * V + i] += red[0][(ty + s) * w + tx * V + i];
        red[1][ty * w + tx * V + i] += red[1][(ty + s) * w + tx * V + i];
      }
    }
  }
  __syncthreads();
}

struct CoopArgs {
  const void* a;       // (rows, C): x, or dy in the backward
  const void* x;       // backward: (rows, C), a's type
  const float* mean;   // backward
  const float* inv;    // backward
  const float* gamma;  // FWD, BWD_FUSED
  const float* beta;   // FWD, BWD_FUSED with ReLU
  float* part;         // (2, P, C) per-slab partial sums
  unsigned* sync;      // (2,): barrier arrivals, generation; arrivals 0
  float* out0;         // (C,): Σx; FWD mean; backward Σdy
  float* out1;         // (C,): Σx²; FWD var; backward Σ(dy·x̂)
  void* out;           // FWD y, BWD_FUSED dx: (rows, C) in the input type
  long long rows;
  long long slab;  // rows per slab
  int C;
  int P;      // slabs
  int items;  // channel blocks x slabs
  float eps;  // FWD
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V values of T global -> shared: cp.async for 4, 8 or 16 bytes (landing
// after the thread's wait on its group), a plain copy for 2 (bf16, V = 1)
template <typename T, int V>
__device__ __forceinline__ void copy_in(void* dst, const T* src) {
  constexpr int B = sizeof(T) * V;
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (B >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(B)
                 : "memory");
  } else {
    *reinterpret_cast<Pack<T, V>*>(dst) =
        *reinterpret_cast<const Pack<T, V>*>(src);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Grid-wide barrier k (1, 2) of a cooperative launch: sync[0] counts
// arrivals (0 on entry, reset to 0 by the last arrival), sync[1] is a
// generation, `gen0` its value when the kernel started (read by CTA
// thread 0 only; no other launch on the stream runs meanwhile), so barrier
// k ends when it reaches gen0 + k. A wait past 2^32 clocks (~2 s) traps.
__device__ __forceinline__ void grid_sync(unsigned* sync, unsigned gen0,
                                          int k) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(sync)
                 : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(sync)
                   : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(
                       sync + 1)
                   : "memory");
    } else {
      const long long t0 = clock64();
      while ((int)(ld_acquire(sync + 1) - gen0) < k) {
        if (clock64() - t0 > (1ll << 32)) __trap();
      }
    }
  }
  __syncthreads();
}

// Phase k's time stamp. Built with -DBN_STAMPS (tools/bn_phases.py), CTA
// b writes %globaltimer (ns) to word k of its 8 u64 at sync + 64 + 16b
// (the caller passes a larger sync buffer): 0 start, 1 phase 0 done, 2
// past barrier 1, 3 finalised, 4 past barrier 2, 5 phase 1 done. Empty
// otherwise.
__device__ __forceinline__ void stamp(unsigned* sync, int k) {
#ifdef BN_STAMPS
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    reinterpret_cast<unsigned long long*>(sync + 64)[blockIdx.x * 8 + k] = t;
  }
#else
  (void)sync;
  (void)k;
#endif
}

// One thread's rows of one (channel block, slab) item: row(j) = r0 + ty +
// j·TY for j < J, its OPS operands in slot(j) of the thread's shared
// memory.
template <typename T, int V, int OPS, int RING>
struct Rows {
  const T* in[OPS];  // x; or dy, x
  T* out;            // phase 1's y or dx
  uint4* smem;  // this thread's slot s, operand o at smem[(OPS s + o) NTHREADS]
  long long r0;
  int c, C, TY, J, K;  // K: resident slots (the first K rows keep theirs)

  __device__ __forceinline__ int slot(int j) const {
    return j < K ? j : K + (j - K) % RING;
  }
  __device__ __forceinline__ long long off(int j) const {
    return (r0 + (long long)j * TY) * C + c;
  }
  __device__ __forceinline__ void issue(int j) const {
    uint4* s = smem + OPS * slot(j) * NTHREADS;
#pragma unroll
    for (int o = 0; o < OPS; ++o)
      copy_in<T, V>(s + o * NTHREADS, in[o] + off(j));
  }
  __device__ __forceinline__ void get(int j, float (&v)[OPS][V]) const {
    const uint4* s = smem + OPS * slot(j) * NTHREADS;
#pragma unroll
    for (int o = 0; o < OPS; ++o)
      load<T, V>(reinterpret_cast<const T*>(s + o * NTHREADS), v[o]);
  }
};

// A thread's per-channel constants, and what a mode does with one row
template <int MODE, typename T, int V, bool RELU>
struct Chan {
  static constexpr int OPS = Layout<MODE>::OPS;
  float mean[V], inv[V], gam[V], bet[V];  // the backward's inputs
  float scale[V], shift[V];               // FWD's phase 1
  float m_dy[V], m_dyx[V], gi[V];         // BWD_FUSED's phase 1

  // backward: x̂ = (x − mean)·inv, dy zeroed where x̂γ + β > 0 fails
  __device__ __forceinline__ void xhat_mask(const float (&vx)[V],
                                            float (&vd)[V],
                                            float (&xh)[V]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      xh[i] = __fmul_rn(__fsub_rn(vx[i], mean[i]), inv[i]);
      if (RELU && !(__fadd_rn(__fmul_rn(xh[i], gam[i]), bet[i]) > 0.f))
        vd[i] = 0.f;
    }
  }

  // phase 0: Σx, Σx²; or Σdy, Σ(dy·x̂)
  __device__ __forceinline__ void add(float (&v)[OPS][V], float (&s0)[V],
                                      float (&s1)[V]) const {
    if constexpr (OPS == 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s0[i] += v[0][i];
        s1[i] += __fmul_rn(v[0][i], v[0][i]);
      }
    } else {
      float xh[V];
      xhat_mask(v[1], v[0], xh);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s0[i] += v[0][i];
        s1[i] += __fmul_rn(v[0][i], xh[i]);
      }
    }
  }

  // phase 1: y = x·scale + shift [ReLU]; or
  // dx = (dy − Σdy/n − x̂·Σ(dy·x̂)/n)·γ·inv
  __device__ __forceinline__ void emit(float (&v)[OPS][V],
                                       float (&out)[V]) const {
    if constexpr (MODE == FWD) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float y = __fadd_rn(__fmul_rn(v[0][i], scale[i]), shift[i]);
        out[i] = RELU ? fmaxf(y, 0.f) : y;
      }
    } else {
      float xh[V];
      xhat_mask(v[1], v[0], xh);
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = __fmul_rn(__fsub_rn(__fsub_rn(v[0][i], m_dy[i]),
                                     __fmul_rn(xh[i], m_dyx[i])),
                           gi[i]);
    }
  }
};

template <int MODE, typename T, int V, bool RELU>
using RowsOf = Rows<T, V, Layout<MODE>::OPS, Layout<MODE>::RING>;

// Phase 0 of one item: every row into the sums, RING rows in flight
template <int MODE, typename T, int V, bool RELU>
__device__ __forceinline__ void sweep(const RowsOf<MODE, T, V, RELU>& rw,
                                      const Chan<MODE, T, V, RELU>& ch,
                                      float (&s0)[V], float (&s1)[V]) {
  constexpr int RING = Layout<MODE>::RING;
#pragma unroll
  for (int j = 0; j < RING; ++j) {
    if (j < rw.J) rw.issue(j);
    cp_commit();
  }
  for (int j = 0; j < rw.J; ++j) {
    cp_wait<RING - 1>();
    float v[Layout<MODE>::OPS][V];
    rw.get(j, v);
    ch.add(v, s0, s1);
    // refill the slot only once its values are in use: the copy may not
    // overtake the read
    if (j + RING < rw.J) rw.issue(j + RING);
    cp_commit();
  }
}

// row j's output from its slot
template <int MODE, typename T, int V, bool RELU>
__device__ __forceinline__ void emit_row(const RowsOf<MODE, T, V, RELU>& rw,
                                     const Chan<MODE, T, V, RELU>& ch, int j) {
  float v[Layout<MODE>::OPS][V], out[V];
  rw.get(j, v);
  ch.emit(v, out);
  store<T, V>(rw.out + rw.off(j), out);
}

// Phase 1 of one item: the rows still held in shared memory first (the
// last RING of the sweep when `tail`, then the K resident ones), then the
// rest backwards through the ring.
template <int MODE, typename T, int V, bool RELU>
__device__ __forceinline__ void apply_back(const RowsOf<MODE, T, V, RELU>& rw,
                                           const Chan<MODE, T, V, RELU>& ch,
                                           bool tail) {
  constexpr int RING = Layout<MODE>::RING;
  const int J = rw.J, K = rw.K;
  int next;  // the first row of the backward stream
  if (tail) {
    for (int j = J - 1; j >= max(K, J - RING); --j) {
      emit_row(rw, ch, j);
      if (j - RING >= K) rw.issue(j - RING);  // into the slot just read
      cp_commit();
    }
    next = J - RING - 1;
  } else {
#pragma unroll
    for (int i = 0; i < RING; ++i) {
      if (J - 1 - i >= K) rw.issue(J - 1 - i);
      cp_commit();
    }
    next = J - 1;
  }
  for (int j = 0; j < min(K, J); ++j) emit_row(rw, ch, j);
  for (int j = next; j >= K; --j) {
    cp_wait<RING - 1>();
    emit_row(rw, ch, j);
    if (j - RING >= K) rw.issue(j - RING);
    cp_commit();
  }
}

template <int MODE, typename T, int V, bool RELU>
__global__ void __launch_bounds__(NTHREADS, 2) bn_coop_kernel(CoopArgs g) {
  using L = Layout<MODE>;
  extern __shared__ uint4 ring[];
  __shared__ float red[2][NTHREADS * MAXV];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int C = g.C;
  const int blocks = g.items / g.P;
  const bool single = g.items <= (int)gridDim.x;  // one item a CTA
  const int w = TX * V;

  RowsOf<MODE, T, V, RELU> rw;
  rw.in[0] = static_cast<const T*>(g.a);
  if constexpr (L::OPS == 2) rw.in[1] = static_cast<const T*>(g.x);
  rw.out = static_cast<T*>(g.out);
  rw.smem = ring + ty * TX + tx;
  rw.C = C;
  rw.TY = TY;
  rw.K = single ? L::RESIDENT : 0;
  Chan<MODE, T, V, RELU> ch;
  auto item = [&](int it) {  // point rw at item `it`; false if no channel
    const int b = it % blocks, s = it / blocks;
    rw.c = (b * TX + tx) * V;
    const long long r0 = (long long)s * g.slab;
    const long long r1 = min(r0 + g.slab, g.rows);
    rw.r0 = r0 + ty;
    rw.J = (rw.c < C && rw.r0 < r1) ? (int)((r1 - rw.r0 + TY - 1) / TY) : 0;
    if constexpr (L::OPS == 2) {
      if (rw.c < C) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          ch.mean[i] = g.mean[rw.c + i];
          ch.inv[i] = g.inv[rw.c + i];
          ch.gam[i] = MODE == BWD_FUSED ? g.gamma[rw.c + i] : 0.f;
          ch.bet[i] = RELU ? g.beta[rw.c + i] : 0.f;
        }
      }
    }
    return rw.c < C;
  };

  const unsigned gen0 =
      (tx == 0 && ty == 0) ? ld_acquire(g.sync + 1) : 0u;
  stamp(g.sync, 0);

  // phase 0: per-slab partials
  for (int it = blockIdx.x; it < g.items; it += (int)gridDim.x) {
    float s0[V], s1[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s0[i] = s1[i] = 0.f;
    const bool live = item(it);
    sweep<MODE, T, V, RELU>(rw, ch, s0, s1);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[0][ty * w + tx * V + i] = s0[i];
      red[1][ty * w + tx * V + i] = s1[i];
    }
    tree_reduce<V>(red, tx, ty, TX, TY);
    if (ty == 0 && live) {
      const int s = it / blocks;
      float* p0 = g.part + (long long)s * C + rw.c;
      float* p1 = g.part + ((long long)g.P + s) * C + rw.c;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        p0[i] = red[0][tx * V + i];
        p1[i] = red[1][tx * V + i];
      }
    }
    __syncthreads();  // red is rewritten by the next item
  }
  stamp(g.sync, 1);
  grid_sync(g.sync, gen0, 1);
  stamp(g.sync, 2);

  // finalisation: CTA i sums the partials of channels [lo, hi), a warp a
  // channel, lanes over slabs, then a butterfly (fixed order)
  {
    const int per = (C + gridDim.x - 1) / gridDim.x;
    const int lo = blockIdx.x * per, hi = min(C, lo + per);
    const int tid = ty * TX + tx, lane = tid & 31;
    for (int cc = lo + tid / 32; cc < hi; cc += NTHREADS / 32) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int p = lane; p < g.P; p += 32) {
        a0 += __ldcg(g.part + (long long)p * C + cc);
        a1 += __ldcg(g.part + ((long long)g.P + p) * C + cc);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a0 += __shfl_xor_sync(0xffffffffu, a0, o);
        a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      }
      if (lane == 0) {
        if constexpr (MODE == FWD) {  // mean, var = max(Σx²/n − mean², 0)
          const float n = (float)g.rows;
          const float m = __fdiv_rn(a0, n);
          g.out0[cc] = m;
          g.out1[cc] =
              fmaxf(__fsub_rn(__fdiv_rn(a1, n), __fmul_rn(m, m)), 0.f);
        } else {
          g.out0[cc] = a0;
          g.out1[cc] = a1;
        }
      }
    }
  }
  stamp(g.sync, 3);
  if constexpr (L::EMITS) {
    grid_sync(g.sync, gen0, 2);
    stamp(g.sync, 4);
    // phase 1: y or dx, items in the reverse of phase 0's order. An item's
    // per-channel constants are formed once per CTA into `red`, read
    // coalesced: a read of its V values by every thread, V floats apart
    // across a warp, aims ~50k threads at the same few L2 lines.
    const int last = blockIdx.x + ((g.items - 1 - (int)blockIdx.x) /
                                   (int)gridDim.x) * (int)gridDim.x;
    const int tid = ty * TX + tx;
    for (int it = last; it >= 0; it -= (int)gridDim.x) {
      const bool live = item(it);
      const int cc = (it % blocks) * w + tid;  // w <= NTHREADS channels
      __syncthreads();  // the previous item's constants are read
      if (tid < w && cc < C) {
        if constexpr (MODE == FWD) {  // scale = rsqrt(var + eps)·γ
          const float scale = __fmul_rn(
              __frsqrt_rn(__fadd_rn(__ldcg(g.out1 + cc), g.eps)),
              g.gamma[cc]);
          red[0][tid] = scale;
          red[1][tid] =
              __fsub_rn(g.beta[cc], __fmul_rn(__ldcg(g.out0 + cc), scale));
        } else {
          const float n = (float)g.rows;
          red[0][tid] = __fdiv_rn(__ldcg(g.out0 + cc), n);
          red[1][tid] = __fdiv_rn(__ldcg(g.out1 + cc), n);
        }
      }
      __syncthreads();
      if (!live || rw.J == 0) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if constexpr (MODE == FWD) {
          ch.scale[i] = red[0][tx * V + i];
          ch.shift[i] = red[1][tx * V + i];
        } else {
          ch.m_dy[i] = red[0][tx * V + i];
          ch.m_dyx[i] = red[1][tx * V + i];
          ch.gi[i] = __fmul_rn(ch.gam[i], ch.inv[i]);
        }
      }
      apply_back<MODE, T, V, RELU>(rw, ch, single);
    }
    stamp(g.sync, 5);
  }
}

// ---------------------------------------------------------------- launches
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

// Run CALL(T, V) for the instance of (is_bf16, vec) that exists (V <= 16
// bytes of T), returning its cudaError_t.
#define BN_DISPATCH(is_bf16, vec, CALL)               \
  do {                                                \
    if (is_bf16) {                                    \
      switch (vec) {                                  \
        case 1: return CALL(bf16, 1);                 \
        case 2: return CALL(bf16, 2);                 \
        case 4: return CALL(bf16, 4);                 \
        case 8: return CALL(bf16, 8);                 \
      }                                               \
    } else {                                          \
      switch (vec) {                                  \
        case 1: return CALL(float, 1);                \
        case 2: return CALL(float, 2);                \
        case 4: return CALL(float, 4);                \
      }                                               \
    }                                                 \
    return cudaErrorInvalidValue;                     \
  } while (0)

using CoopKernel = void (*)(CoopArgs);

// the bn_coop_kernel instance of (mode, relu, T, V) and its dynamic shared
// memory (*smem), that size allowed; null if that failed. relu is taken
// only by FWD and BWD_FUSED; mode is one of the four.
template <typename T, int V>
CoopKernel coop_tv(int mode, int relu, size_t* smem) {
  CoopKernel k;
  switch (mode) {
    case STATS:
      k = bn_coop_kernel<STATS, T, V, false>;
      *smem = Layout<STATS>::SMEM;
      break;
    case FWD:
      k = relu ? bn_coop_kernel<FWD, T, V, true>
               : bn_coop_kernel<FWD, T, V, false>;
      *smem = Layout<FWD>::SMEM;
      break;
    case BWD_STATS:
      k = bn_coop_kernel<BWD_STATS, T, V, false>;
      *smem = Layout<BWD_STATS>::SMEM;
      break;
    default:
      k = relu ? bn_coop_kernel<BWD_FUSED, T, V, true>
               : bn_coop_kernel<BWD_FUSED, T, V, false>;
      *smem = Layout<BWD_FUSED>::SMEM;
  }
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem) == cudaSuccess
             ? k
             : nullptr;
}

template <typename T, int V>
cudaError_t coop_ctas_tv(int mode, int relu, int sms, int* ctas) {
  size_t smem = 0;
  CoopKernel k = coop_tv<T, V>(mode, relu, &smem);
  if (k == nullptr) return cudaGetLastError();
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k, NTHREADS, smem);
  *ctas = per_sm * sms;
  return e;
}

template <typename T, int V>
cudaError_t coop_launch_tv(int mode, int relu, dim3 grid, dim3 block,
                           const CoopArgs& g, cudaStream_t s) {
  size_t smem = 0;
  CoopKernel k = coop_tv<T, V>(mode, relu, &smem);
  if (k == nullptr) return cudaGetLastError();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, k, g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool valid_mode(int mode) { return mode >= STATS && mode <= BWD_FUSED; }

bool emits(int mode) { return mode == FWD || mode == BWD_FUSED; }

}  // namespace

// CTAs of bn_coop_kernel in `mode` (0 bn_stats, 1 bn_fwd_apply, 2
// bn_bwd_stats, 3 bn_bwd_fused) that the card holds at once: the most a
// cooperative launch of it may have, written to *ctas.
extern "C" int bn_coop_ctas(int mode, int is_bf16, int relu, int vec,
                            int device, int* ctas) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  if (!valid_mode(mode)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
#define BN_CTAS(T, V) \
  coop_ctas_tv<T, V>(mode, relu && emits(mode), sms, ctas)
  BN_DISPATCH(is_bf16, vec, BN_CTAS);
#undef BN_CTAS
}

// One of the four kernels as one cooperative launch of `ctas` CTAs over
// channel blocks of tx·vec channels x `slabs` slabs of `slab` rows. `a` is
// x (modes 0, 1) or dy (2, 3, with x); out0/out1 receive Σx and Σx² (0),
// the mean and var (1), or Σdy and Σ(dy·x̂) (2, 3); `out` y (1) or dx (3).
// `sync` holds two counters, the first 0 (it is 0 again when the kernel
// ends).
extern "C" int bn_coop(int mode, int is_bf16, int relu, int vec, int tx,
                       int ctas, int slabs, long long slab, const void* a,
                       const void* x, const float* mean, const float* inv,
                       const float* gamma, const float* beta, float* part,
                       unsigned* sync, float* out0, float* out1, void* out,
                       long long rows, int C, float eps, int device,
                       void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const int cb = tx * vec;
  const long long items = (long long)((C + cb - 1) / cb) * slabs;
  if (!valid_mode(mode) || tx < 1 || tx > 32 || (tx & (tx - 1)) ||
      C % vec || rows < 1 || slabs < 1 || ctas < 1 ||
      items > (1ll << 30) || (long long)slabs * slab < rows ||
      (emits(mode) && out == nullptr) || (mode >= BWD_STATS && x == nullptr))
    return (int)cudaErrorInvalidValue;
  CoopArgs g = {};
  g.a = a;
  g.x = x;
  g.mean = mean;
  g.inv = inv;
  g.gamma = gamma;
  g.beta = beta;
  g.part = part;
  g.sync = sync;
  g.out0 = out0;
  g.out1 = out1;
  g.out = out;
  g.rows = rows;
  g.slab = slab;
  g.C = C;
  g.P = slabs;
  g.items = (int)items;
  g.eps = eps;
  const dim3 grid(ctas), block(tx, NTHREADS / tx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BN_COOP(T, V) \
  coop_launch_tv<T, V>(mode, relu && emits(mode), grid, block, g, s)
  BN_DISPATCH(is_bf16, vec, BN_COOP);
#undef BN_COOP
}
