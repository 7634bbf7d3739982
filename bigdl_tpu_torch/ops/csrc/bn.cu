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
// accumulator carried from one grid step to the next); at ResNet-50's C =
// 64..2048 that is 1..16 programs, far too few for 132 SMs. Here rows are
// split into P slabs as well as channels into blocks. A CTA of 256
// threads has TX across channels (V channels a thread, 16 bytes at a time
// where C allows) and TY across rows.
//
// The forward pair (bn_stats, bn_fwd_apply):
//   bn_reduce_kernel  grid (channel blocks, P). Each CTA sums its slab in
//       f32 registers, reduces over TY through shared memory and writes one
//       (2, C) partial; the last CTA of a channel block to finish (an
//       integer counter, zeroed by the caller) sums the P partials in slab
//       order and finalises: the sums (stats), or mean/var and the (scale,
//       shift) of the apply (fwd).
//   bn_apply_kernel  grid (channel blocks, P): y from (scale, shift).
//
// The backward pair (bn_bwd_stats, bn_bwd_fused): bn_bwd_kernel, one
// cooperative launch of as many CTAs as the card holds at once (the
// occupancy API's CTAs per SM x SMs), each owning one (channel block,
// slab); a CTA loops over several only when C has more blocks than that.
//   phase 0  Each thread streams its own rows of dy and x into its own
//       slots of shared memory with 16-byte cp.async, RING rows ahead of
//       the one it reduces, so no thread waits on another's copies. The
//       first RESIDENT rows keep their slots; later rows cycle through the
//       RING slots. Σdy and Σ(dy·x̂) in f32 registers, with the ReLU mask;
//       a tree over TY; one (2, C) partial per slab.
//   barrier  Grid-wide; then every CTA finalises a few channels, a warp a
//       channel, its lanes summing the P partials in a fixed order and a
//       butterfly of shuffles combining them.
//   phase 1 (bn_bwd_fused only)  A second barrier, then dx: first the rows
//       still in shared memory (the last RING of the sweep, then the
//       RESIDENT ones), then the rest of the slab read backwards, so what
//       phase 0 read last, most likely still in the 50 MB L2, is read
//       first. 16-byte stores.
// The barrier's two counters (arrivals, generation): the arrivals are zero
// at the start and the last CTA to arrive resets them, so the wrapper
// launches this one kernel and nothing else. A wait that has not ended after ~2 s
// traps instead of hanging the card.
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
// bn_bwd_kernel's shared memory a thread: SLOTS (dy, x) pairs of 16 bytes,
// RING of them cycling, the rest holding the first rows of its slab
constexpr int RING = 4;
constexpr int SLOTS = 11;
constexpr int RESIDENT = SLOTS - RING;
constexpr size_t BWD_SMEM = (size_t)SLOTS * 2 * 16 * NTHREADS;  // 88 KB

enum Mode : int { STATS = 0, FWD = 2 };

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

// ------------------------------------------------------------ forward pair
struct Args {
  const void* x;        // (rows, C)
  const float* gamma;   // FWD (C,)
  const float* beta;    // FWD (C,)
  const float* aux_in;  // bn_apply: (2, C) from bn_reduce's aux
  float* part;          // (2, P, C) per-slab partial sums
  unsigned* count;      // (channel blocks,) slabs finished, zeroed
  float* out0;          // (C,): Σx, FWD mean
  float* out1;          // (C,): Σx², FWD var
  float* aux;           // FWD (2, C): scale, shift
  void* y;              // bn_apply: (rows, C) output in the input type
  long long rows;
  long long slab;  // rows per slab
  int C;
  int P;
  float eps;
};

template <int MODE, typename T, int V>
__global__ void __launch_bounds__(NTHREADS) bn_reduce_kernel(Args g) {
  __shared__ float red[2][NTHREADS * MAXV];
  __shared__ bool is_last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int c = (blockIdx.x * TX + tx) * V;
  const bool live = c < g.C;  // C % V == 0: a vector is all in or all out
  const int C = g.C;

  float s0[V], s1[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s0[i] = s1[i] = 0.f;
  const long long r0 = (long long)blockIdx.y * g.slab;
  const long long r1 = min(r0 + g.slab, g.rows);
  if (live) {
    const T* a = static_cast<const T*>(g.x);
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += TY) {
      float va[V];
      load<T, V>(a + r * C + c, va);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s0[i] += va[i];
        s1[i] += __fmul_rn(va[i], va[i]);
      }
    }
  }
  const int w = TX * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][ty * w + tx * V + i] = s0[i];
    red[1][ty * w + tx * V + i] = s1[i];
  }
  tree_reduce<V>(red, tx, ty, TX, TY);
  if (ty == 0 && live) {
    float* p0 = g.part + (long long)blockIdx.y * C;
    float* p1 = g.part + ((long long)g.P + blockIdx.y) * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p0[c + i] = red[0][tx * V + i];
      p1[c + i] = red[1][tx * V + i];
    }
  }
  // the last CTA of this channel block to finish sums the P partials
  __threadfence();
  __syncthreads();
  if (tx == 0 && ty == 0)
    is_last = atomicAdd(&g.count[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

#pragma unroll
  for (int i = 0; i < V; ++i) s0[i] = s1[i] = 0.f;
  if (live) {
    for (int p = ty; p < g.P; p += TY) {
      const float* p0 = g.part + (long long)p * C + c;
      const float* p1 = g.part + ((long long)g.P + p) * C + c;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s0[i] += __ldcg(p0 + i);
        s1[i] += __ldcg(p1 + i);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][ty * w + tx * V + i] = s0[i];
    red[1][ty * w + tx * V + i] = s1[i];
  }
  tree_reduce<V>(red, tx, ty, TX, TY);
  if (ty != 0 || !live) return;
  const float n = (float)g.rows;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int cc = c + i;
    const float t0 = red[0][tx * V + i], t1 = red[1][tx * V + i];
    if (MODE == FWD) {
      const float m = __fdiv_rn(t0, n);
      const float var =
          fmaxf(__fsub_rn(__fdiv_rn(t1, n), __fmul_rn(m, m)), 0.f);
      const float scale = __fmul_rn(__frsqrt_rn(__fadd_rn(var, g.eps)),
                                    g.gamma[cc]);
      g.out0[cc] = m;
      g.out1[cc] = var;
      g.aux[cc] = scale;
      g.aux[C + cc] = __fsub_rn(g.beta[cc], __fmul_rn(m, scale));
    } else {
      g.out0[cc] = t0;
      g.out1[cc] = t1;
    }
  }
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(NTHREADS) bn_apply_kernel(Args g) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = (blockIdx.x * blockDim.x + tx) * V;
  if (c >= g.C) return;
  const int C = g.C;
  float scale[V], shift[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    scale[i] = g.aux_in[c + i];
    shift[i] = g.aux_in[C + c + i];
  }
  const T* a = static_cast<const T*>(g.x);
  T* y = static_cast<T*>(g.y);
  const long long r0 = (long long)blockIdx.y * g.slab;
  const long long r1 = min(r0 + g.slab, g.rows);
#pragma unroll 4
  for (long long r = r0 + ty; r < r1; r += blockDim.y) {
    float va[V], out[V];
    load<T, V>(a + r * C + c, va);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = __fadd_rn(__fmul_rn(va[i], scale[i]), shift[i]);
      out[i] = RELU ? fmaxf(v, 0.f) : v;
    }
    store<T, V>(y + r * C + c, out);
  }
}

// ----------------------------------------------------------- backward pair
struct BwdArgs {
  const void* dy;  // (rows, C)
  const void* x;   // (rows, C), dy's type
  const float* mean;
  const float* inv;
  const float* gamma;  // fused only
  const float* beta;   // fused only
  float* part;         // (2, P, C) per-slab partial sums
  unsigned* sync;      // (2,): barrier arrivals, generation; arrivals 0
  float* sdy;          // (C,) Σdy
  float* sdyx;         // (C,) Σ(dy·x̂)
  void* dx;            // fused: (rows, C) in the input type
  long long rows;
  long long slab;  // rows per slab
  int C;
  int P;      // slabs
  int items;  // channel blocks x slabs
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

// One thread's rows of one (channel block, slab) item: row(j) = r0 + ty +
// j·TY for j < J, its (dy, x) in slot(j) of the thread's shared memory.
template <typename T, int V>
struct Rows {
  const T* dy;
  const T* x;
  T* dx;
  uint4* smem;  // this thread's slot s, operand o at smem[(2s + o) NTHREADS]
  long long r0;
  int c, C, TY, J, K;  // K: resident slots (the first K rows keep theirs)

  __device__ __forceinline__ int slot(int j) const {
    return j < K ? j : K + (j - K) % RING;
  }
  __device__ __forceinline__ long long off(int j) const {
    return (r0 + (long long)j * TY) * C + c;
  }
  __device__ __forceinline__ void issue(int j) const {
    uint4* s = smem + 2 * slot(j) * NTHREADS;
    copy_in<T, V>(s, dy + off(j));
    copy_in<T, V>(s + NTHREADS, x + off(j));
  }
  __device__ __forceinline__ void get(int j, float (&vd)[V],
                                      float (&vx)[V]) const {
    const uint4* s = smem + 2 * slot(j) * NTHREADS;
    load<T, V>(reinterpret_cast<const T*>(s), vd);
    load<T, V>(reinterpret_cast<const T*>(s + NTHREADS), vx);
  }
};

template <typename T, int V, bool RELU>
struct Chan {  // a thread's per-channel constants
  float mean[V], inv[V], gam[V], bet[V];

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
};

template <typename T, int V, bool RELU>
__device__ __forceinline__ void sweep(const Rows<T, V>& rw,
                                      const Chan<T, V, RELU>& ch,
                                      float (&s0)[V], float (&s1)[V]) {
#pragma unroll
  for (int j = 0; j < RING; ++j) {
    if (j < rw.J) rw.issue(j);
    cp_commit();
  }
  for (int j = 0; j < rw.J; ++j) {
    cp_wait<RING - 1>();
    float vd[V], vx[V], xh[V];
    rw.get(j, vd, vx);
    ch.xhat_mask(vx, vd, xh);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s0[i] += vd[i];
      s1[i] += __fmul_rn(vd[i], xh[i]);
    }
    // refill the slot only once its values are in use: the copy may not
    // overtake the read
    if (j + RING < rw.J) rw.issue(j + RING);
    cp_commit();
  }
}

// dx of row j from its slot: (dy − Σdy/n − x̂·Σ(dy·x̂)/n)·γ·inv
template <typename T, int V, bool RELU>
__device__ __forceinline__ void emit(const Rows<T, V>& rw,
                                     const Chan<T, V, RELU>& ch,
                                     const float (&m_dy)[V],
                                     const float (&m_dyx)[V],
                                     const float (&gi)[V], int j) {
  float vd[V], vx[V], xh[V], out[V];
  rw.get(j, vd, vx);
  ch.xhat_mask(vx, vd, xh);
#pragma unroll
  for (int i = 0; i < V; ++i)
    out[i] = __fmul_rn(
        __fsub_rn(__fsub_rn(vd[i], m_dy[i]), __fmul_rn(xh[i], m_dyx[i])),
        gi[i]);
  store<T, V>(rw.dx + rw.off(j), out);
}

// Phase 1 of one item: the rows still held in shared memory first (the
// last RING of the sweep when `tail`, then the K resident ones), then the
// rest backwards through the ring.
template <typename T, int V, bool RELU>
__device__ __forceinline__ void apply_back(const Rows<T, V>& rw,
                                           const Chan<T, V, RELU>& ch,
                                           const float (&m_dy)[V],
                                           const float (&m_dyx)[V],
                                           const float (&gi)[V], bool tail) {
  const int J = rw.J, K = rw.K;
  int next;  // the first row of the backward stream
  if (tail) {
    for (int j = J - 1; j >= max(K, J - RING); --j) {
      emit(rw, ch, m_dy, m_dyx, gi, j);
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
  for (int j = 0; j < min(K, J); ++j) emit(rw, ch, m_dy, m_dyx, gi, j);
  for (int j = next; j >= K; --j) {
    cp_wait<RING - 1>();
    emit(rw, ch, m_dy, m_dyx, gi, j);
    if (j - RING >= K) rw.issue(j - RING);
    cp_commit();
  }
}

template <bool FUSED, typename T, int V, bool RELU>
__global__ void __launch_bounds__(NTHREADS, 2) bn_bwd_kernel(BwdArgs g) {
  extern __shared__ uint4 ring[];
  __shared__ float red[2][NTHREADS * MAXV];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int C = g.C;
  const int blocks = g.items / g.P;
  const bool single = g.items <= (int)gridDim.x;  // one item a CTA
  const int w = TX * V;

  Rows<T, V> rw;
  rw.dy = static_cast<const T*>(g.dy);
  rw.x = static_cast<const T*>(g.x);
  rw.dx = static_cast<T*>(g.dx);
  rw.smem = ring + ty * TX + tx;
  rw.C = C;
  rw.TY = TY;
  rw.K = single ? RESIDENT : 0;
  Chan<T, V, RELU> ch;
  auto item = [&](int it) {  // point rw at item `it`; false if no channel
    const int b = it % blocks, s = it / blocks;
    rw.c = (b * TX + tx) * V;
    const long long r0 = (long long)s * g.slab;
    const long long r1 = min(r0 + g.slab, g.rows);
    rw.r0 = r0 + ty;
    rw.J = (rw.c < C && rw.r0 < r1) ? (int)((r1 - rw.r0 + TY - 1) / TY) : 0;
    if (rw.c < C) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ch.mean[i] = g.mean[rw.c + i];
        ch.inv[i] = g.inv[rw.c + i];
        ch.gam[i] = FUSED ? g.gamma[rw.c + i] : 0.f;
        ch.bet[i] = RELU ? g.beta[rw.c + i] : 0.f;
      }
    }
    return rw.c < C;
  };

  const unsigned gen0 =
      (tx == 0 && ty == 0) ? ld_acquire(g.sync + 1) : 0u;

  // phase 0: per-slab partials
  for (int it = blockIdx.x; it < g.items; it += (int)gridDim.x) {
    float s0[V], s1[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s0[i] = s1[i] = 0.f;
    const bool live = item(it);
    sweep<T, V, RELU>(rw, ch, s0, s1);
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
  grid_sync(g.sync, gen0, 1);

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
        g.sdy[cc] = a0;
        g.sdyx[cc] = a1;
      }
    }
  }
  if constexpr (FUSED) {
    grid_sync(g.sync, gen0, 2);
    // phase 1: dx, items in the reverse of phase 0's order
    const float n = (float)g.rows;
    const int last = blockIdx.x + ((g.items - 1 - (int)blockIdx.x) /
                                   (int)gridDim.x) * (int)gridDim.x;
    for (int it = last; it >= 0; it -= (int)gridDim.x) {
      if (!item(it) || rw.J == 0) continue;
      float m_dy[V], m_dyx[V], gi[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        m_dy[i] = __fdiv_rn(__ldcg(g.sdy + rw.c + i), n);
        m_dyx[i] = __fdiv_rn(__ldcg(g.sdyx + rw.c + i), n);
        gi[i] = __fmul_rn(ch.gam[i], ch.inv[i]);
      }
      apply_back<T, V, RELU>(rw, ch, m_dy, m_dyx, gi, single);
    }
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

template <typename T, int V>
cudaError_t reduce_tv(int mode, dim3 grid, dim3 block, const Args& g,
                      cudaStream_t s) {
  if (mode == FWD)
    bn_reduce_kernel<FWD, T, V><<<grid, block, 0, s>>>(g);
  else
    bn_reduce_kernel<STATS, T, V><<<grid, block, 0, s>>>(g);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t apply_tv(int relu, dim3 grid, dim3 block, const Args& g,
                     cudaStream_t s) {
  if (relu)
    bn_apply_kernel<T, V, true><<<grid, block, 0, s>>>(g);
  else
    bn_apply_kernel<T, V, false><<<grid, block, 0, s>>>(g);
  return cudaGetLastError();
}

using BwdKernel = void (*)(BwdArgs);

// the bn_bwd_kernel instance of (fused, relu, T, V), its dynamic shared
// memory allowed; null if that failed
template <typename T, int V>
BwdKernel bwd_tv(int fused, int relu) {
  BwdKernel k = fused ? (relu ? bn_bwd_kernel<true, T, V, true>
                              : bn_bwd_kernel<true, T, V, false>)
                      : bn_bwd_kernel<false, T, V, false>;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)BWD_SMEM) == cudaSuccess
             ? k
             : nullptr;
}

template <typename T, int V>
cudaError_t bwd_ctas_tv(int fused, int relu, int sms, int* ctas) {
  BwdKernel k = bwd_tv<T, V>(fused, relu);
  if (k == nullptr) return cudaGetLastError();
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k, NTHREADS, BWD_SMEM);
  *ctas = per_sm * sms;
  return e;
}

template <typename T, int V>
cudaError_t bwd_launch_tv(int fused, int relu, dim3 grid, dim3 block,
                          const BwdArgs& g, cudaStream_t s) {
  BwdKernel k = bwd_tv<T, V>(fused, relu);
  if (k == nullptr) return cudaGetLastError();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = BWD_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, k, g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The forward pair's sweep (mode 0: Σx, Σx²; mode 2: mean, var and the
// (scale, shift) of bn_apply in aux): per-slab partials into `part`, then
// the last CTA of each channel block finalises. Returns a cudaError_t (0
// on success).
extern "C" int bn_reduce(int mode, int is_bf16, int vec, int tx, int slabs,
                         long long slab, const void* x, const float* gamma,
                         const float* beta, float* part, unsigned* count,
                         float* out0, float* out1, float* aux, long long rows,
                         int C, float eps, int device, void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  if (tx < 1 || tx > 32 || (tx & (tx - 1)) || C % vec || rows < 1 ||
      slabs < 1 || slabs > 65535 || (mode != STATS && mode != FWD))
    return (int)cudaErrorInvalidValue;
  Args g = {};
  g.x = x;
  g.gamma = gamma;
  g.beta = beta;
  g.part = part;
  g.count = count;
  g.out0 = out0;
  g.out1 = out1;
  g.aux = aux;
  g.rows = rows;
  g.slab = slab;
  g.C = C;
  g.P = slabs;
  g.eps = eps;
  const int cb = tx * vec;
  const dim3 grid((C + cb - 1) / cb, slabs), block(tx, NTHREADS / tx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BN_REDUCE(T, V) reduce_tv<T, V>(mode, grid, block, g, s)
  BN_DISPATCH(is_bf16, vec, BN_REDUCE);
#undef BN_REDUCE
}

// bn_fwd_apply's elementwise pass, y from the (scale, shift) bn_reduce
// left in `aux`.
extern "C" int bn_apply(int is_bf16, int relu, int vec, int tx, int slabs,
                        long long slab, const void* x, const float* aux,
                        void* y, long long rows, int C, int device,
                        void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  if (tx < 1 || tx > 32 || (tx & (tx - 1)) || C % vec || rows < 1 ||
      slabs < 1 || slabs > 65535)
    return (int)cudaErrorInvalidValue;
  Args g = {};
  g.x = x;
  g.aux_in = aux;
  g.y = y;
  g.rows = rows;
  g.slab = slab;
  g.C = C;
  g.P = slabs;
  const int cb = tx * vec;
  const dim3 grid((C + cb - 1) / cb, slabs), block(tx, NTHREADS / tx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BN_APPLY(T, V) apply_tv<T, V>(relu, grid, block, g, s)
  BN_DISPATCH(is_bf16, vec, BN_APPLY);
#undef BN_APPLY
}

// CTAs of bn_bwd_kernel (fused or not) that the card holds at once: the
// most a cooperative launch of it may have, written to *ctas.
extern "C" int bn_bwd_ctas(int fused, int is_bf16, int relu, int vec,
                           int device, int* ctas) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
#define BN_CTAS(T, V) bwd_ctas_tv<T, V>(fused, relu && fused, sms, ctas)
  BN_DISPATCH(is_bf16, vec, BN_CTAS);
#undef BN_CTAS
}

// bn_bwd_stats (fused 0: Σdy, Σ(dy·x̂)) or bn_bwd_fused (fused 1: also
// dx) as one cooperative launch of `ctas` CTAs over channel blocks of tx·vec
// channels x `slabs` slabs of `slab` rows. `sync` holds two counters, the
// first 0 (it is 0 again when the kernel ends).
extern "C" int bn_bwd(int fused, int is_bf16, int relu, int vec, int tx,
                      int ctas, int slabs, long long slab, const void* dy,
                      const void* x, const float* mean, const float* inv,
                      const float* gamma, const float* beta, float* part,
                      unsigned* sync, float* sdy, float* sdyx, void* dx,
                      long long rows, int C, int device, void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const int cb = tx * vec;
  const long long items = (long long)((C + cb - 1) / cb) * slabs;
  if (tx < 1 || tx > 32 || (tx & (tx - 1)) || C % vec || rows < 1 ||
      slabs < 1 || ctas < 1 || items > (1ll << 30) ||
      (long long)slabs * slab < rows || (fused && dx == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs g = {};
  g.dy = dy;
  g.x = x;
  g.mean = mean;
  g.inv = inv;
  g.gamma = gamma;
  g.beta = beta;
  g.part = part;
  g.sync = sync;
  g.sdy = sdy;
  g.sdyx = sdyx;
  g.dx = dx;
  g.rows = rows;
  g.slab = slab;
  g.C = C;
  g.P = slabs;
  g.items = (int)items;
  const dim3 grid(ctas), block(tx, NTHREADS / tx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BN_BWD(T, V) \
  bwd_launch_tv<T, V>(fused, relu && fused, grid, block, g, s)
  BN_DISPATCH(is_bf16, vec, BN_BWD);
#undef BN_BWD
}
