// Batch-norm kernels for Hopper (sm_90a), f32 and bf16 inputs, f32 sums.
//
// Replace the four Pallas TPU kernels of bigdl_tpu/ops/bn_kernel.py:
//
//   _stats_kernel   (bn_stats)      Σx, Σx² per channel
//   _bwd_kernel     (bn_bwd_stats)  Σdy, Σ(dy·x̂) per channel, x̂ in f32
//   _fba_fwd_kernel (bn_fwd_apply)  the stats, then
//                                   y = x·scale + (β − mean·scale) [ReLU]
//   _fba_bwd_kernel (bn_bwd_fused)  x̂ = (x − mean)·inv, dy masked where
//                                   x̂γ + β <= 0 [ReLU], Σdy, Σ(dy·x̂), then
//                                   dx = (dy − Σdy/n − x̂·Σ(dy·x̂)/n)·γ·inv
//
// over a (rows, C) array whose rows are C contiguous values (NHWC
// activations seen as 2-D). They compute what those kernels compute, with
// the JAX package's numerics: f32 accumulation whatever the input type,
// var = max(Σx²/n − mean², 0) (not Welford), y and dx computed in f32 and
// rounded once to the input type, the strict > 0 of the recomputed ReLU
// mask. Every rows >= 1 and C >= 1 is taken: channels past C are masked.
//
// What bounds them on an H100: a few operations per element against 2 or
// 4 bytes read, so HBM bandwidth. The floor is one read of each input
// (x; dy and x̂; dy and x) and one write of each output (y; dx).
//
// Design. The TPU grid walks rows serially inside one 128-channel block
// (a VMEM accumulator carried from one grid step to the next); at
// ResNet-50's C = 64..2048 that is 1..16 programs, far too few for 132
// SMs. Here rows are split into P slabs as well as channels into blocks:
//
//   bn_reduce_kernel  grid (channel blocks, P). A CTA of 256 threads (TX
//       across channels, V channels a thread loaded 16 bytes at a time
//       where C allows; TY across rows) sums its slab in f32 registers,
//       reduces over TY through shared memory, and writes one (2, C)
//       partial per slab. The last CTA of a channel block to finish (an
//       integer counter, zeroed by the caller) sums the P partials in slab
//       order and finalises: the sums themselves (stats, bwd_stats),
//       mean/var plus the (scale, shift) of the apply (fwd), or Σdy,
//       Σ(dy·x̂) plus their means (bwd).
//   bn_apply_kernel  grid (channel blocks, P). The elementwise pass of fwd
//       (y) or bwd (dx): each thread keeps its channels' constants in
//       registers and streams its rows.
//
// No float atomics, and every sum is taken in an order fixed by the launch
// plan (rows, C, dtype, alignment and the card's SM count), so a result is
// the same from run to run. bn_stats and bn_bwd_stats are one launch each;
// bn_fwd_apply and bn_bwd_fused two (the phase-0 sweep, then the phase-1
// re-read that the TPU kernel does inside one grid). Elementwise arithmetic
// avoids FMA contraction (__fmul_rn, __fadd_rn) so it rounds as the plain
// PyTorch version does. Not done yet: keeping a slab on chip between the
// two phases, so the fused kernels read their inputs once instead of twice
// (the bound counts one read).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;
constexpr int MAXV = 8;  // channels a thread loads at once (16 bytes of bf16)

enum Mode : int { STATS = 0, BWD_STATS = 1, FWD = 2, BWD = 3 };

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

struct Args {
  const void* a;   // x (STATS, FWD) or dy (BWD_STATS, BWD), (rows, C)
  const void* b;   // x̂ f32 (BWD_STATS) or x (BWD), (rows, C); else null
  // per-channel f32 (C,): FWD gamma, beta; BWD mean, inv, gamma, beta
  const float* p0;
  const float* p1;
  const float* p2;
  const float* p3;
  const float* aux_in;  // bn_apply: (2, C) from bn_reduce's aux
  float* part;          // (2, P, C) per-slab partial sums
  unsigned* count;      // (channel blocks,) slabs finished, zeroed
  float* out0;          // (C,): Σ, FWD mean, BWD Σdy
  float* out1;          // (C,): Σ², FWD var, BWD Σ(dy·x̂)
  float* aux;           // (2, C): FWD scale, shift; BWD Σdy/n, Σ(dy·x̂)/n
  void* y;              // bn_apply: (rows, C) output in the input type
  long long rows;
  long long slab;  // rows per slab
  int C;
  int P;
  float eps;
};

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

template <int MODE, typename T, int V, bool RELU>
__global__ void __launch_bounds__(NTHREADS) bn_reduce_kernel(Args g) {
  using TB = std::conditional_t<MODE == BWD_STATS, float, T>;
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
  float mean[V], inv[V], gam[V], bet[V];
  if (MODE == BWD && live) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = g.p0[c + i];
      inv[i] = g.p1[c + i];
      gam[i] = g.p2[c + i];
      bet[i] = g.p3[c + i];
    }
  }
  const long long r0 = (long long)blockIdx.y * g.slab;
  const long long r1 = min(r0 + g.slab, g.rows);
  if (live) {
    const T* a = static_cast<const T*>(g.a);
    const TB* b = static_cast<const TB*>(g.b);
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += TY) {
      float va[V];
      load<T, V>(a + r * C + c, va);
      if (MODE == STATS || MODE == FWD) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s0[i] += va[i];
          s1[i] += __fmul_rn(va[i], va[i]);
        }
      } else {
        float vb[V];
        load<TB, V>(b + r * C + c, vb);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float dy = va[i], xh = vb[i];
          if (MODE == BWD) {
            xh = __fmul_rn(__fsub_rn(vb[i], mean[i]), inv[i]);
            if (RELU && !(__fadd_rn(__fmul_rn(xh, gam[i]), bet[i]) > 0.f))
              dy = 0.f;
          }
          s0[i] += dy;
          s1[i] += __fmul_rn(dy, xh);
        }
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
                                    g.p0[cc]);
      g.out0[cc] = m;
      g.out1[cc] = var;
      g.aux[cc] = scale;
      g.aux[C + cc] = __fsub_rn(g.p1[cc], __fmul_rn(m, scale));
    } else {
      g.out0[cc] = t0;
      g.out1[cc] = t1;
      if (MODE == BWD) {
        g.aux[cc] = __fdiv_rn(t0, n);
        g.aux[C + cc] = __fdiv_rn(t1, n);
      }
    }
  }
}

template <int MODE, typename T, int V, bool RELU>
__global__ void __launch_bounds__(NTHREADS) bn_apply_kernel(Args g) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = (blockIdx.x * blockDim.x + tx) * V;
  if (c >= g.C) return;
  const int C = g.C;
  // FWD: k0 scale, k1 shift. BWD: k0 mean, k1 inv, k2 gamma, k3 beta,
  // k4 Σdy/n, k5 Σ(dy·x̂)/n, k6 gamma·inv
  float k0[V], k1[V], k2[V], k3[V], k4[V], k5[V], k6[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (MODE == FWD) {
      k0[i] = g.aux_in[c + i];
      k1[i] = g.aux_in[C + c + i];
    } else {
      k0[i] = g.p0[c + i];
      k1[i] = g.p1[c + i];
      k2[i] = g.p2[c + i];
      k3[i] = g.p3[c + i];
      k4[i] = g.aux_in[c + i];
      k5[i] = g.aux_in[C + c + i];
      k6[i] = __fmul_rn(k2[i], k1[i]);
    }
  }
  const T* a = static_cast<const T*>(g.a);
  const T* b = static_cast<const T*>(g.b);
  T* y = static_cast<T*>(g.y);
  const long long r0 = (long long)blockIdx.y * g.slab;
  const long long r1 = min(r0 + g.slab, g.rows);
#pragma unroll 4
  for (long long r = r0 + ty; r < r1; r += blockDim.y) {
    float va[V], out[V];
    load<T, V>(a + r * C + c, va);
    if (MODE == FWD) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float v = __fadd_rn(__fmul_rn(va[i], k0[i]), k1[i]);
        out[i] = RELU ? fmaxf(v, 0.f) : v;
      }
    } else {
      float vb[V];
      load<T, V>(b + r * C + c, vb);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = __fmul_rn(__fsub_rn(vb[i], k0[i]), k1[i]);
        float dy = va[i];
        if (RELU && !(__fadd_rn(__fmul_rn(xh, k2[i]), k3[i]) > 0.f)) dy = 0.f;
        out[i] = __fmul_rn(
            __fsub_rn(__fsub_rn(dy, k4[i]), __fmul_rn(xh, k5[i])), k6[i]);
      }
    }
    store<T, V>(y + r * C + c, out);
  }
}

template <bool APPLY, int MODE, typename T, bool RELU>
cudaError_t launch_v(int vec, dim3 grid, dim3 block, const Args& g,
                     cudaStream_t s) {
  switch (vec) {
#define BN_CASE(V)                                                     \
  case V:                                                              \
    if constexpr (APPLY)                                               \
      bn_apply_kernel<MODE, T, V, RELU><<<grid, block, 0, s>>>(g);            \
    else                                                               \
      bn_reduce_kernel<MODE, T, V, RELU><<<grid, block, 0, s>>>(g);           \
    break;
    BN_CASE(1)
    BN_CASE(2)
    BN_CASE(4)
    case 8:
      if constexpr (sizeof(T) == 2) {
        if constexpr (APPLY)
          bn_apply_kernel<MODE, T, 8, RELU><<<grid, block, 0, s>>>(g);
        else
          bn_reduce_kernel<MODE, T, 8, RELU><<<grid, block, 0, s>>>(g);
        break;
      }
      return cudaErrorInvalidValue;
#undef BN_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool APPLY, int MODE>
cudaError_t launch_mode(int is_bf16, int relu, int vec, dim3 grid,
                        dim3 block, const Args& g, cudaStream_t s) {
  if (is_bf16)
    return relu ? launch_v<APPLY, MODE, bf16, true>(vec, grid, block, g, s)
                : launch_v<APPLY, MODE, bf16, false>(vec, grid, block, g, s);
  return relu ? launch_v<APPLY, MODE, float, true>(vec, grid, block, g, s)
              : launch_v<APPLY, MODE, float, false>(vec, grid, block, g, s);
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

cudaError_t launch(bool apply, int mode, int is_bf16, int relu, int vec,
                   int tx, const Args& g, int device, void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  if (tx < 1 || tx > 32 || (tx & (tx - 1)) || vec < 1 || vec > MAXV ||
      g.C % vec || g.rows < 1 || g.P < 1 || g.P > 65535 ||
      (apply && mode != FWD && mode != BWD))
    return cudaErrorInvalidValue;
  const int cb = tx * vec;
  const dim3 grid((g.C + cb - 1) / cb, g.P), block(tx, NTHREADS / tx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ReLU changes only the fused kernels; the others take one instance
  relu = relu && (mode == BWD || (apply && mode == FWD));
  switch (mode) {
    case STATS:
      return launch_mode<false, STATS>(is_bf16, 0, vec, grid, block, g, s);
    case BWD_STATS:
      return launch_mode<false, BWD_STATS>(is_bf16, 0, vec, grid, block, g,
                                           s);
    case FWD:
      return apply ? launch_mode<true, FWD>(is_bf16, relu, vec, grid, block,
                                            g, s)
                   : launch_mode<false, FWD>(is_bf16, 0, vec, grid, block, g,
                                             s);
    case BWD:
      return apply ? launch_mode<true, BWD>(is_bf16, relu, vec, grid, block,
                                            g, s)
                   : launch_mode<false, BWD>(is_bf16, relu, vec, grid, block,
                                             g, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The phase-0 sweep of every kernel: per-slab partials into `part`, then
// the last CTA of each channel block finalises into out0, out1 (and aux).
// Returns a cudaError_t (0 on success).
extern "C" int bn_reduce(int mode, int is_bf16, int relu, int vec, int tx,
                         int slabs, long long slab, const void* a,
                         const void* b, const float* p0, const float* p1,
                         const float* p2, const float* p3, float* part,
                         unsigned* count, float* out0, float* out1,
                         float* aux, long long rows, int C, float eps,
                         int device, void* stream) {
  Args g = {};
  g.a = a;
  g.b = b;
  g.p0 = p0;
  g.p1 = p1;
  g.p2 = p2;
  g.p3 = p3;
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
  return (int)launch(false, mode, is_bf16, relu, vec, tx, g, device, stream);
}

// The elementwise phase of the fused kernels (mode FWD: y; mode BWD: dx)
// from the constants bn_reduce left in `aux`.
extern "C" int bn_apply(int mode, int is_bf16, int relu, int vec, int tx,
                        int slabs, long long slab, const void* a,
                        const void* b, const float* p0, const float* p1,
                        const float* p2, const float* p3, const float* aux,
                        void* y, long long rows, int C, int device,
                        void* stream) {
  Args g = {};
  g.a = a;
  g.b = b;
  g.p0 = p0;
  g.p1 = p1;
  g.p2 = p2;
  g.p3 = p3;
  g.aux_in = aux;
  g.y = y;
  g.rows = rows;
  g.slab = slab;
  g.C = C;
  g.P = slabs;
  return (int)launch(true, mode, is_bf16, relu, vec, tx, g, device, stream);
}
