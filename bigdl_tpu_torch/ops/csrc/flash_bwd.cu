// Flash-attention backward for Hopper (sm_90a), f32 and bf16, head_dim
// 16..128: two kernels, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` of
// bigdl_tpu/ops/attention_kernel.py (reached through `_flash_bwd` and
// `pl.pallas_call`). With the forward's per-row lse and the per-row
// delta = rowsum(dO * O) (computed beside the launch in plain PyTorch, as
// the JAX package computes it in plain XLA):
//
//   P  = exp(Q K^T * scale - lse), 0 where the mask says no (selected, so a
//        row with no live key, lse = -1e30, gives 0 and not inf * 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale
//   dQ = dS K           (dS rounded to K's type first)      -- flash_dq
//   dV = P^T dO         (P rounded to dO's type first)      -- flash_dkv
//   dK = dS^T Q         (dS rounded to Q's type first)      -- flash_dkv
//
// The mask is the forward's: bottom-right causal triangle and, for packed
// rows, equal segment ids. The two-kernel split of the TPU package is
// kept, so every output tile is written once by one CTA, without atomics,
// and the result does not depend on the order the CTAs run in.
//
// What bounds them on an H100: at the training shape (8 x 8 heads of 128,
// s = 1024, causal) the pair reads and writes ~50 MB but runs 7 products
// of 2 x 128 FLOP over each of the 34M score entries the mask leaves, so
// the floor is the bf16 tensor cores: 0.061 ms for both at 989 TFLOP/s.
// What keeps them from it is feeding them: operands re-read from shared
// memory, the elementwise pass between the products, and loads that do
// not overlap compute. The mma.sync design this replaces (64-row CTAs of
// 4 warps, ldmatrix from padded tiles, cp.async one stage deep) ran the
// pair in 0.484 ms on an H100 80GB HBM3 at 700 W; this one in ~0.18
// (PERF.md).
//
// bf16 at d = 64 and 128, the Hopper kernels. A unit is one 128-row tile
// of one (batch, head): keys for flash_dkv, queries for flash_dq. One
// persistent CTA an SM walks its units (heaviest first: low key tiles and
// high query tiles see the most of the causal triangle), with two consumer
// warpgroups of 64 rows each and a producer warpgroup whose first warp
// loads; setmaxnreg moves registers to the consumers (240 and 24 a thread).
//   Loads: every tile by TMA through a 4-D tensor map (d, s, h, b) of the
//     operand's own strides, 128-byte swizzled (a d = 128 row is two
//     64-column boxes), rows past s read as 0. A unit's own two tiles
//     (K, V or Q, dO) go to one of two buffers, a unit ahead; the other
//     side's 64-row tiles stream through a ring of STAGES stages with
//     full/empty mbarriers, their lse, delta and segment ids by cp.async
//     beside them, so the producer never waits on a load.
//   flash_dkv, per query tile: S^T = K Q^T and dP^T = V dO^T as wgmma
//     m64n64k16 from shared memory (K-major); P^T and dS^T in registers,
//     rounded to bf16 and fed back as register A operands of dV += P^T dO
//     and dK += dS^T Q (m64nDk16, dO and Q read MN-major from the same
//     stage). dK and dV stay in registers (128 floats a thread at d = 128).
//   flash_dq, per key tile: S = Q K^T and dP = dO V^T from shared memory,
//     dS from registers into dQ += dS K, K read MN-major.
// The elementwise pass tests the mask only in tiles that cross the
// diagonal or an edge and takes exp2 as one MUFU.EX2 (exp2f's subnormal
// handling cost as much as the rest of the pass). Measured limits that
// remain: both warpgroups of a CTA run their products and their
// elementwise passes at the same time, so the tensor cores idle during
// the latter (taking turns through named barriers measured slower), and a
// two-stage ring leaves some waits for the streamed tiles.
//
// bf16 at d = 16 and 32 stays on mma.sync m16n8k16 (one CTA of 4 warps per
// 64-row tile, cp.async double buffering): a wgmma k-step of a 128-byte
// swizzled tile wants 64 columns. f32 runs as plain FMA (no TF32) through
// shared memory, the JAX f32 arithmetic. The choice is made by dtype and d
// up front.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*H, Sq)
  const float* delta;  // (B*H, Sq)
  const int* seg;      // (B, S) segment ids, contiguous, or null; S = Sq = Sk
  void* dq;
  void* dk;
  void* dv;
  int H, Sq, Sk, causal;
  float scale;
  // element strides of (batch, head, row); the last dim is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* base, int b, int h,
                                       long long sb, long long sh) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

template <typename T>
__device__ __forceinline__ T* at_mut(void* base, int b, int h, long long sb,
                                     long long sh) {
  return static_cast<T*>(base) + b * sb + h * sh;
}

// 64-key tiles the query rows < q_end need, fully-future tiles left out
// under causal
__device__ __forceinline__ int key_tiles_to(int q_end, const Params& p) {
  int n = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int q_last = p.Sk - p.Sq + q_end - 1;
    n = min(n, q_last < 0 ? 0 : q_last / BK + 1);
  }
  return n;
}

// K tiles the query tile at q0 needs (the forward's count)
__device__ __forceinline__ int key_tiles(int q0, const Params& p) {
  return key_tiles_to(min(q0 + BQ, p.Sq), p);
}

// the first query tile that sees any key of the key tile at k0: the one
// holding query max(0, k0 - q_offset)
__device__ __forceinline__ int first_query_tile(int k0, const Params& p) {
  if (!p.causal) return 0;
  return max(0, k0 - (p.Sk - p.Sq)) / BQ;
}

// does the (q0, k0) tile pair need the per-element mask?
__device__ __forceinline__ bool needs_mask(int q0, int k0, const Params& p) {
  return p.seg || q0 + BQ > p.Sq || k0 + BK > p.Sk ||
         (p.causal && k0 + BK - 1 > p.Sk - p.Sq + q0);
}

__device__ __forceinline__ bool visible(int qi, int kj, int qseg, int kseg,
                                        const Params& p) {
  return qi < p.Sq && live(kj, qi, p.Sk, p.Sk - p.Sq, p.causal) &&
         (!p.seg || qseg == kseg);
}

// ============================================================ f32: FMA path
template <int D> struct LayoutF32 {
  using L = F32<D>;
  static constexpr size_t a_off = 0;  // the CTA's own Q (dq) or K (dkv)
  static constexpr size_t b_off = align128(a_off + 4 * BQ * L::LDT);  // dO / V
  static constexpr size_t c_off = align128(b_off + 4 * BQ * L::LDT);  // K / Q
  static constexpr size_t d_off = align128(c_off + 4 * BK * L::LDT);  // V / dO
  static constexpr size_t s_off = align128(d_off + 4 * BK * L::LDT);
  static constexpr size_t p_off = align128(s_off + 4 * BQ * L::LDS);
  static constexpr size_t acc_off = align128(p_off + 4 * BQ * L::LDS);
  static constexpr size_t lse_off = align128(acc_off + 4 * BQ * L::LDO);
  static constexpr size_t dl_off = lse_off + 4 * BQ;
  static constexpr size_t qs_off = dl_off + 4 * BQ;
  static constexpr size_t ks_off = qs_off + 4 * BQ;
  static constexpr size_t bytes = ks_off + 4 * BK;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_dq_f32(Params p) {
  using L = LayoutF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::a_off);
  float* Ds = reinterpret_cast<float*>(smem + L::b_off);
  float* Ks = reinterpret_cast<float*>(smem + L::c_off);
  float* Vs = reinterpret_cast<float*>(smem + L::d_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);   // S, then dS
  float* Ps = reinterpret_cast<float*>(smem + L::p_off);   // dP
  float* Acc = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + L::dl_off);
  int* qs = reinterpret_cast<int*>(smem + L::qs_off);
  int* ks = reinterpret_cast<int*>(smem + L::ks_off);

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const float* qg = at<float>(p.q, b, h, p.q_sb, p.q_sh);
  const float* kg = at<float>(p.k, b, h, p.k_sb, p.k_sh);
  const float* vg = at<float>(p.v, b, h, p.v_sb, p.v_sh);
  const float* dog = at<float>(p.dout, b, h, p.do_sb, p.do_sh);
  float* dqg = at_mut<float>(p.dq, b, h, p.dq_sb, p.dq_sh);
  const int* sg = p.seg ? p.seg + (long long)b * p.Sk : nullptr;

  load_tile_f32<D>(Qs, qg, q0, p.Sq, p.q_ss);
  load_tile_f32<D>(Ds, dog, q0, p.Sq, p.do_ss);
  load_rows(lse_s, p.lse + (long long)bh * p.Sq, q0, p.Sq, 0.f);
  load_rows(dl_s, p.delta + (long long)bh * p.Sq, q0, p.Sq, 0.f);
  if (sg) load_rows(qs, sg, q0, p.Sq, 0);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS)
    Acc[(i / D) * F32<D>::LDO + i % D] = 0.f;
  const int n_tiles = key_tiles(q0, p);
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    load_tile_f32<D>(Ks, kg, k0, p.Sk, p.k_ss);
    load_tile_f32<D>(Vs, vg, k0, p.Sk, p.v_ss);
    if (sg) load_rows(ks, sg, k0, p.Sk, -1);
    __syncthreads();
    mm_nt_f32<D>(Qs, Ks, Ss, p.scale);  // S
    mm_nt_f32<D>(Ds, Vs, Ps, 1.f);      // dP
    __syncthreads();
    const bool mask = needs_mask(q0, k0, p);
    for (int i = threadIdx.x; i < BQ * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      float ds = 0.f;
      if (!mask || visible(q0 + r, k0 + c, qs[r], ks[c], p)) {
        const float pr = expf(Ss[r * F32<D>::LDS + c] - lse_s[r]);
        ds = pr * (Ps[r * F32<D>::LDS + c] - dl_s[r]) * p.scale;
      }
      Ss[r * F32<D>::LDS + c] = ds;
    }
    __syncthreads();
    mm_acc_f32_smem<D>(Ss, Ks, Acc);  // dQ += dS K
    __syncthreads();
  }

  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < p.Sq)
      dqg[(long long)(q0 + r) * p.dq_ss + c] = Acc[r * F32<D>::LDO + c];
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_f32(Params p) {
  using L = LayoutF32<D>;
  constexpr int NJ = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + L::a_off);
  float* Vs = reinterpret_cast<float*>(smem + L::b_off);
  float* Qs = reinterpret_cast<float*>(smem + L::c_off);
  float* Ds = reinterpret_cast<float*>(smem + L::d_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);  // S^T, then P^T
  float* Ps = reinterpret_cast<float*>(smem + L::p_off);  // dP^T, then dS^T
  float* dKs = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + L::dl_off);
  int* qs = reinterpret_cast<int*>(smem + L::qs_off);
  int* ks = reinterpret_cast<int*>(smem + L::ks_off);

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BK;  // low key tiles see the most queries
  const float* qg = at<float>(p.q, b, h, p.q_sb, p.q_sh);
  const float* kg = at<float>(p.k, b, h, p.k_sb, p.k_sh);
  const float* vg = at<float>(p.v, b, h, p.v_sb, p.v_sh);
  const float* dog = at<float>(p.dout, b, h, p.do_sb, p.do_sh);
  float* dkg = at_mut<float>(p.dk, b, h, p.dk_sb, p.dk_sh);
  float* dvg = at_mut<float>(p.dv, b, h, p.dv_sb, p.dv_sh);
  const int* sg = p.seg ? p.seg + (long long)b * p.Sk : nullptr;

  load_tile_f32<D>(Ks, kg, k0, p.Sk, p.k_ss);
  load_tile_f32<D>(Vs, vg, k0, p.Sk, p.v_ss);
  if (sg) load_rows(ks, sg, k0, p.Sk, -1);
  for (int i = threadIdx.x; i < BK * D; i += NTHREADS)
    dKs[(i / D) * F32<D>::LDO + i % D] = 0.f;
  float dv[8][NJ];  // rows 8ty.., columns tx + 16j of dV, in registers
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dv[i][j] = 0.f;
  const int n_q = (p.Sq + BQ - 1) / BQ;

  for (int qt = first_query_tile(k0, p); qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    load_tile_f32<D>(Qs, qg, q0, p.Sq, p.q_ss);
    load_tile_f32<D>(Ds, dog, q0, p.Sq, p.do_ss);
    load_rows(lse_s, p.lse + (long long)bh * p.Sq, q0, p.Sq, 0.f);
    load_rows(dl_s, p.delta + (long long)bh * p.Sq, q0, p.Sq, 0.f);
    if (sg) load_rows(qs, sg, q0, p.Sq, 0);
    __syncthreads();
    mm_nt_f32<D>(Ks, Qs, Ss, p.scale);  // S^T (keys x queries)
    mm_nt_f32<D>(Vs, Ds, Ps, 1.f);      // dP^T
    __syncthreads();
    const bool mask = needs_mask(q0, k0, p);
    for (int i = threadIdx.x; i < BK * BQ; i += NTHREADS) {
      const int r = i / BQ, c = i % BQ;  // key r, query c
      float pr = 0.f, ds = 0.f;
      if (!mask || visible(q0 + c, k0 + r, qs[c], ks[r], p)) {
        pr = expf(Ss[r * F32<D>::LDS + c] - lse_s[c]);
        ds = pr * (Ps[r * F32<D>::LDS + c] - dl_s[c]) * p.scale;
      }
      Ss[r * F32<D>::LDS + c] = pr;
      Ps[r * F32<D>::LDS + c] = ds;
    }
    __syncthreads();
    mm_acc_f32<D>(Ss, Ds, dv);        // dV += P^T dO
    mm_acc_f32_smem<D>(Ps, Qs, dKs);  // dK += dS^T Q
    __syncthreads();
  }

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = k0 + ty * 8 + i;
    if (r >= p.Sk) break;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      dvg[(long long)r * p.dv_ss + c] = dv[i][j];
      dkg[(long long)r * p.dk_ss + c] = dKs[(ty * 8 + i) * F32<D>::LDO + c];
    }
  }
}

// ================================== bf16, d = 16 and 32: mma.sync path
template <int D> struct LayoutBF16 {
  static constexpr int TILE = BF16<D>::TILE;
  // the CTA's own two tiles (Q, dO for dq; K, V for dkv), then two stages
  // each of the two streamed tiles (K, V for dq; Q, dO for dkv), then two
  // stages of the streamed rows' segment ids, lse and delta
  static constexpr size_t rows_off = 6 * TILE * sizeof(bf16);
  static constexpr size_t bytes = rows_off + 2 * 3 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_dq_bf16_small(Params p) {
  using L = LayoutBF16<D>;
  constexpr int LDT = BF16<D>::LDT;
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int NO = D / 8;   // n-blocks of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + L::TILE;
  bf16* Ks = Qs + 2 * L::TILE;  // stages at Ks, Ks + TILE
  bf16* Vs = Qs + 4 * L::TILE;  // stages at Vs, Vs + TILE
  int* kseg = reinterpret_cast<int*>(smem + L::rows_off);  // stages of BK ids

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const bf16* qg = at<bf16>(p.q, b, h, p.q_sb, p.q_sh);
  const bf16* kg = at<bf16>(p.k, b, h, p.k_sb, p.k_sh);
  const bf16* vg = at<bf16>(p.v, b, h, p.v_sb, p.v_sh);
  const bf16* dog = at<bf16>(p.dout, b, h, p.do_sb, p.do_sh);
  bf16* dqg = at_mut<bf16>(p.dq, b, h, p.dq_sb, p.dq_sh);
  const int* sg = p.seg ? p.seg + (long long)b * p.Sk : nullptr;

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + w * 16 + g, row1 = row0 + 8;  // this thread's rows
  // rows past Sq read 0 and compute garbage that is never stored (each dQ
  // row depends on its own row only)
  const float* lse_g = p.lse + (long long)bh * p.Sq;
  const float* dl_g = p.delta + (long long)bh * p.Sq;
  const float lse0 = row0 < p.Sq ? lse_g[row0] : 0.f;
  const float lse1 = row1 < p.Sq ? lse_g[row1] : 0.f;
  const float dl0 = row0 < p.Sq ? dl_g[row0] : 0.f;
  const float dl1 = row1 < p.Sq ? dl_g[row1] : 0.f;
  const int qs0 = sg && row0 < p.Sq ? sg[row0] : 0;
  const int qs1 = sg && row1 < p.Sq ? sg[row1] : 0;
  const int n_tiles = key_tiles(q0, p);

  load_tile_bf16<D>(Qs, qg, q0, p.Sq, p.q_ss);
  load_tile_bf16<D>(Ds, dog, q0, p.Sq, p.do_ss);
  if (n_tiles > 0) {
    load_tile_bf16<D>(Ks, kg, 0, p.Sk, p.k_ss);
    load_tile_bf16<D>(Vs, vg, 0, p.Sk, p.v_ss);
    if (sg) load_rows(kseg, sg, 0, p.Sk, -1);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const bf16* qa = Qs + w * 16 * LDT + a_frag_offset(lane, LDT);
  const bf16* da = Ds + w * 16 * LDT + a_frag_offset(lane, LDT);
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {  // prefetch the next K/V tile
      load_tile_bf16<D>(Ks + (st ^ 1) * L::TILE, kg, (tile + 1) * BK, p.Sk,
                        p.k_ss);
      load_tile_bf16<D>(Vs + (st ^ 1) * L::TILE, vg, (tile + 1) * BK, p.Sk,
                        p.v_ss);
      if (sg) load_rows(kseg + (st ^ 1) * BK, sg, (tile + 1) * BK, p.Sk, -1);
    }
    cp_async_commit();
    const bf16* Kt = Ks + st * L::TILE;
    const bf16* Vt = Vs + st * L::TILE;
    const int* kst = kseg + st * BK;
    const int k0 = tile * BK;

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys each
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    const bf16* kr = Kt + b_frag_offset(lane, LDT);
    const bf16* vr = Vt + b_frag_offset(lane, LDT);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], bb[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        ldmatrix_x4(bb, kr + j * 8 * LDT + kk * 16);
        mma_bf16(s[j], a, bb[0], bb[1]);
        mma_bf16(s[j + 1], a, bb[2], bb[3]);
      }
      ldmatrix_x4(a, da + kk * 16);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        ldmatrix_x4(bb, vr + j * 8 * LDT + kk * 16);
        mma_bf16(dp[j], a, bb[0], bb[1]);
        mma_bf16(dp[j + 1], a, bb[2], bb[3]);
      }
    }

    // dS = P (dP - delta) scale, P = exp(S scale - lse) where visible
    const bool mask = needs_mask(q0, k0, p);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const bool hi = e >= 2;
        float ds = 0.f;
        if (!mask || visible(hi ? row1 : row0, k0 + c, hi ? qs1 : qs0,
                             sg ? kst[c] : 0, p)) {
          const float pr =
              exp2f((s[j][e] * p.scale - (hi ? lse1 : lse0)) * LOG2E);
          ds = pr * (dp[j][e] - (hi ? dl1 : dl0)) * p.scale;
        }
        s[j][e] = ds;
      }

    // dQ += dS K: dS of key blocks 2kk, 2kk+1 is the A fragment of key
    // step kk, and K (keys x head dim) the B operand, transposed by ldmatrix
    const bf16* kt = Kt + bt_frag_offset(lane, LDT);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      c_to_a(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kt + kk * 16 * LDT + n * 8);
        mma_bf16(acc[n], af, kb[0], kb[1]);
        mma_bf16(acc[n + 1], af, kb[2], kb[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and no warp still reads this one
  }

  if (row0 < p.Sq) {
    bf16* r = dqg + (long long)row0 * p.dq_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(r + n * 8) = pack_bf16(acc[n][0], acc[n][1]);
  }
  if (row1 < p.Sq) {
    bf16* r = dqg + (long long)row1 * p.dq_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(r + n * 8) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_bf16_small(Params p) {
  using L = LayoutBF16<D>;
  constexpr int LDT = BF16<D>::LDT;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L::TILE;
  bf16* Qs = Ks + 2 * L::TILE;  // stages at Qs, Qs + TILE
  bf16* Ds = Ks + 4 * L::TILE;  // stages at Ds, Ds + TILE
  int* qseg = reinterpret_cast<int*>(smem + L::rows_off);  // 2 stages each
  float* lse_s = reinterpret_cast<float*>(qseg + 2 * BQ);
  float* dl_s = lse_s + 2 * BQ;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BK;  // low key tiles see the most queries
  const bf16* qg = at<bf16>(p.q, b, h, p.q_sb, p.q_sh);
  const bf16* kg = at<bf16>(p.k, b, h, p.k_sb, p.k_sh);
  const bf16* vg = at<bf16>(p.v, b, h, p.v_sb, p.v_sh);
  const bf16* dog = at<bf16>(p.dout, b, h, p.do_sb, p.do_sh);
  bf16* dkg = at_mut<bf16>(p.dk, b, h, p.dk_sb, p.dk_sh);
  bf16* dvg = at_mut<bf16>(p.dv, b, h, p.dv_sb, p.dv_sh);
  const int* sg = p.seg ? p.seg + (long long)b * p.Sk : nullptr;
  const float* lse_g = p.lse + (long long)bh * p.Sq;
  const float* dl_g = p.delta + (long long)bh * p.Sq;

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + w * 16 + g, key1 = key0 + 8;  // this thread's keys
  const int ks0 = sg && key0 < p.Sk ? sg[key0] : -1;
  const int ks1 = sg && key1 < p.Sk ? sg[key1] : -1;
  const int qt0 = first_query_tile(k0, p);
  const int n_q = (p.Sq + BQ - 1) / BQ;

  load_tile_bf16<D>(Ks, kg, k0, p.Sk, p.k_ss);
  load_tile_bf16<D>(Vs, vg, k0, p.Sk, p.v_ss);
  if (qt0 < n_q) {
    load_tile_bf16<D>(Qs, qg, qt0 * BQ, p.Sq, p.q_ss);
    load_tile_bf16<D>(Ds, dog, qt0 * BQ, p.Sq, p.do_ss);
    if (sg) load_rows(qseg, sg, qt0 * BQ, p.Sq, 0);
    load_rows(lse_s, lse_g, qt0 * BQ, p.Sq, 0.f);
    load_rows(dl_s, dl_g, qt0 * BQ, p.Sq, 0.f);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const bf16* ka = Ks + w * 16 * LDT + a_frag_offset(lane, LDT);
  const bf16* va = Vs + w * 16 * LDT + a_frag_offset(lane, LDT);
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int st = (qt - qt0) & 1;
    const int q0 = qt * BQ;
    if (qt + 1 < n_q) {  // prefetch the next Q/dO tile and its rows
      const int q1 = q0 + BQ;
      load_tile_bf16<D>(Qs + (st ^ 1) * L::TILE, qg, q1, p.Sq, p.q_ss);
      load_tile_bf16<D>(Ds + (st ^ 1) * L::TILE, dog, q1, p.Sq, p.do_ss);
      if (sg) load_rows(qseg + (st ^ 1) * BQ, sg, q1, p.Sq, 0);
      load_rows(lse_s + (st ^ 1) * BQ, lse_g, q1, p.Sq, 0.f);
      load_rows(dl_s + (st ^ 1) * BQ, dl_g, q1, p.Sq, 0.f);
    }
    cp_async_commit();
    const bf16* Qt = Qs + st * L::TILE;
    const bf16* Dt = Ds + st * L::TILE;
    const int* qst = qseg + st * BQ;
    const float* lst = lse_s + st * BQ;
    const float* dst = dl_s + st * BQ;
    const bool mask = needs_mask(q0, k0, p);

    // 16 queries at a time: S^T = K Q^T and dP^T = V dO^T (16 keys x 16
    // queries a warp), then P^T, dS^T, and dV += P^T dO, dK += dS^T Q
#pragma unroll 1
    for (int c = 0; c < BQ / 16; ++c) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const bf16* qb = Qt + c * 16 * LDT + b_frag_offset(lane, LDT);
      const bf16* db = Dt + c * 16 * LDT + b_frag_offset(lane, LDT);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, ka + kk * 16);
        ldmatrix_x4(bb, qb + kk * 16);
        mma_bf16(s[0], a, bb[0], bb[1]);
        mma_bf16(s[1], a, bb[2], bb[3]);
        ldmatrix_x4(a, va + kk * 16);
        ldmatrix_x4(bb, db + kk * 16);
        mma_bf16(dp[0], a, bb[0], bb[1]);
        mma_bf16(dp[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + j * 8 + 2 * t + (e & 1);  // query in tile
          const bool hi = e >= 2;
          float pr = 0.f, ds = 0.f;
          if (!mask || visible(q0 + col, hi ? key1 : key0, sg ? qst[col] : 0,
                               hi ? ks1 : ks0, p)) {
            pr = exp2f((s[j][e] * p.scale - lst[col]) * LOG2E);
            ds = pr * (dp[j][e] - dst[col]) * p.scale;
          }
          s[j][e] = pr;
          dp[j][e] = ds;
        }
      uint32_t pf[4], df[4];
      c_to_a(pf, s[0], s[1]);
      c_to_a(df, dp[0], dp[1]);
      const bf16* dr = Dt + c * 16 * LDT + bt_frag_offset(lane, LDT);
      const bf16* qr = Qt + c * 16 * LDT + bt_frag_offset(lane, LDT);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, dr + n * 8);
        mma_bf16(dv[n], pf, bb[0], bb[1]);
        mma_bf16(dv[n + 1], pf, bb[2], bb[3]);
        ldmatrix_x4_trans(bb, qr + n * 8);
        mma_bf16(dk[n], df, bb[0], bb[1]);
        mma_bf16(dk[n + 1], df, bb[2], bb[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and no warp still reads this one
  }

  if (key0 < p.Sk) {
    bf16* rk = dkg + (long long)key0 * p.dk_ss + 2 * t;
    bf16* rv = dvg + (long long)key0 * p.dv_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(rk + n * 8) = pack_bf16(dk[n][0], dk[n][1]);
      *reinterpret_cast<uint32_t*>(rv + n * 8) = pack_bf16(dv[n][0], dv[n][1]);
    }
  }
  if (key1 < p.Sk) {
    bf16* rk = dkg + (long long)key1 * p.dk_ss + 2 * t;
    bf16* rv = dvg + (long long)key1 * p.dv_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(rk + n * 8) = pack_bf16(dk[n][2], dk[n][3]);
      *reinterpret_cast<uint32_t*>(rv + n * 8) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// ============================== bf16, d = 64 and 128: Hopper (wgmma, TMA)
// Persistent warp-specialised CTAs (hopper.cuh): a unit is one 128-row tile
// of one (batch, head), keys for dkv and queries for dq. The unit's own
// two tiles go to one of two buffers, a unit ahead; the other side's
// 64-row tiles stream through a ring of STAGES stages, two tiles a stage.
using hopper::align1024;
using hopper::CONSUMER_REGS;
using hopper::exp2_ftz;
using hopper::Maps;
using hopper::nth_unit;
using hopper::PRODUCER_REGS;
using hopper::release;
using hopper::THREADS;
using hopper::tma_tile;
constexpr int OWN = 128;           // rows of a unit's own tiles
constexpr int STREAM = 64;         // rows of a streamed tile (BQ = BK)
constexpr int STAGES = 2;
using Bars = hopper::Bars<STAGES>;

template <int D> struct Smem90 {
  static constexpr uint32_t own = OWN * D * 2;        // bytes of an own tile
  static constexpr uint32_t stream = STREAM * D * 2;  // of a streamed tile
  // two buffers of the own tiles A and B, then the stages (two streamed
  // tiles each), then per stage 3 x 64 row values (lse, delta, segment
  // id), then the barriers. Tiles are 1024-byte aligned.
  static constexpr uint32_t stage_off = 4 * own;
  static constexpr uint32_t rows_off = stage_off + STAGES * 2 * stream;
  static constexpr uint32_t bar_off = rows_off + STAGES * 3 * STREAM * 4;
  static constexpr uint32_t bytes = bar_off + Bars::bytes + 1024;
};

// one accumulator row of a thread to bf16: columns 8n + 2t, 8n + 2t + 1
// from entries 4n + E, 4n + E + 1 (E = 0: row g, E = 2: row g + 8)
template <int E, int N>
__device__ __forceinline__ void store_row(bf16* row, const float (&acc)[N],
                                          int t) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n)
    *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
        pack_bf16(acc[4 * n + E], acc[4 * n + E + 1]);
}

// The producer warp's part of unit j: the own tiles into buffer j % 2,
// then `n` streamed tiles from row `row0` on, each with its 64 rows' lse
// and delta (dkv) or segment ids in the stage's row values (`lse` null for
// dq; 0 past `n_rows`). `ring` counts streamed tiles over all units. The
// row values come by cp.async, and each lane's arrival on the stage waits
// for its copies, so the warp never stalls on a global load.
template <int D>
__device__ __forceinline__ void produce_unit(
    const Maps& maps, unsigned char* smem, int j, int& ring, int own_row,
    int row0, int n, int n_rows, int h, int b, const float* lse,
    const float* dl, const int* seg) {
  using S = Smem90<D>;
  const Bars bar(smem, S::bar_off);
  const int lane = threadIdx.x % 32;
  const int ob = j & 1;
  hopper::mbar_wait(&bar.own_empty[ob], ((j >> 1) & 1) ^ 1);
  if (lane == 0) {
    unsigned char* dst = smem + ob * 2 * S::own;
    hopper::mbar_arrive_expect_tx(&bar.own_full[ob], 2 * S::own);
    tma_tile<D>(dst, &maps.a, &bar.own_full[ob], own_row, h, b, OWN);
    tma_tile<D>(dst + S::own, &maps.b, &bar.own_full[ob], own_row, h, b, OWN);
  }
  for (int it = 0; it < n; ++it, ++ring) {
    const int s = ring % STAGES;
    hopper::mbar_wait(&bar.empty[s], ((ring / STAGES) & 1) ^ 1);
    const int r0 = row0 + it * STREAM;
    if (lane == 0) {  // the tiles first: the row values load meanwhile
      unsigned char* st = smem + S::stage_off + s * 2 * S::stream;
      hopper::mbar_expect_tx(&bar.full[s], 2 * S::stream);
      tma_tile<D>(st, &maps.c, &bar.full[s], r0, h, b, STREAM);
      tma_tile<D>(st + S::stream, &maps.e, &bar.full[s], r0, h, b, STREAM);
    }
    float* rows = reinterpret_cast<float*>(smem + S::rows_off) + s * 3 * STREAM;
    for (int i = lane; i < STREAM; i += 32) {
      const bool in = r0 + i < n_rows;
      const int r = in ? r0 + i : 0;
      if (lse) {
        hopper::cp_async4(rows + i, lse + r, in);
        hopper::cp_async4(rows + STREAM + i, dl + r, in);
      }
      if (seg) hopper::cp_async4(rows + 2 * STREAM + i, seg + r, in);
    }
    hopper::cp_async_arrive(&bar.full[s]);
  }
}

// A fragments of the four 16-wide k-steps of a 64-column accumulator
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(c[8 * kk + 2 * i], c[8 * kk + 2 * i + 1]);
}

// acc (64 x D) += A (64 x 64, four register k-steps) B (64 x D, an MN-major
// streamed tile at `b`)
template <int D>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 128)
      hopper::wgmma_rs_n128_tb(acc, a[kk], hopper::mnmajor_desc(b, STREAM, kk));
    else
      hopper::wgmma_rs_n64_tb(acc, a[kk], hopper::mnmajor_desc(b, STREAM, kk));
  }
}

// c (64 x 64) = A (64 rows of an own tile at `a`) B^T (a streamed tile at
// `b`), both K-major over the head dim
template <int D>
__device__ __forceinline__ void mma_ss(float (&c)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss_n64(c, hopper::kmajor_desc(a, OWN, kk),
                         hopper::kmajor_desc(b, STREAM, kk), kk > 0);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_bf16(const __grid_constant__ Maps maps, const Params p,
                  int BH) {
  using S = Smem90<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  hopper::init_barriers<STAGES>(smem, S::bar_off);
  const Bars bar(smem, S::bar_off);
  // unit u: query tile n_qt - 1 - u / BH (the high ones see the most keys)
  // of (batch, head) u % BH
  const int n_qt = (p.Sq + OWN - 1) / OWN, n_units = n_qt * BH;
  const int warp = threadIdx.x / 32;

  if (warp >= 8) {  // producer: Q, dO a unit ahead; K, V and key ids
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > 8) return;
    for (int i = 0, j = 0, ring = 0; i * (int)gridDim.x < n_units; ++i) {
      const int u = nth_unit(i, n_units);
      if (u < 0) continue;
      const int bh = u % BH, b = bh / p.H, h = bh % p.H;
      const int q0 = (n_qt - 1 - u / BH) * OWN;
      produce_unit<D>(maps, smem, j++, ring, q0, 0,
                      key_tiles_to(min(q0 + OWN, p.Sq), p), p.Sk, h, b,
                      nullptr, nullptr,
                      p.seg ? p.seg + (long long)b * p.Sk : nullptr);
    }
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4, w = warp % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * LOG2E;  // P = exp2(S sl2 - lse log2(e))
  float acc[D / 2], s[32], dp[32];
  uint32_t af[4][4];

  for (int i = 0, j = 0, ring = 0; i * (int)gridDim.x < n_units; ++i) {
    const int u = nth_unit(i, n_units);
    if (u < 0) continue;
    const int ob = j & 1;
    const int bh = u % BH, b = bh / p.H, h = bh % p.H;
    const int q0 = (n_qt - 1 - u / BH) * OWN;
    const int n_tiles = key_tiles_to(min(q0 + OWN, p.Sq), p);
    const int* sg = p.seg ? p.seg + (long long)b * p.Sk : nullptr;
    const int qw = q0 + wg * 64;  // this warpgroup's 64 query rows
    const int n_mine = qw < p.Sq ? key_tiles_to(min(qw + 64, p.Sq), p) : 0;
    const int row0 = qw + w * 16 + g, row1 = row0 + 8;  // this thread's
    // rows past Sq read 0 and compute values that are never stored
    const float* lse_g = p.lse + (long long)bh * p.Sq;
    const float* dl_g = p.delta + (long long)bh * p.Sq;
    const float ll0 = row0 < p.Sq ? lse_g[row0] * LOG2E : 0.f;
    const float ll1 = row1 < p.Sq ? lse_g[row1] * LOG2E : 0.f;
    const float dl0 = row0 < p.Sq ? dl_g[row0] : 0.f;
    const float dl1 = row1 < p.Sq ? dl_g[row1] : 0.f;
    const int qs0 = sg && row0 < p.Sq ? sg[row0] : 0;
    const int qs1 = sg && row1 < p.Sq ? sg[row1] : 0;
    const uint32_t qa = hopper::smem_u32(smem + ob * 2 * S::own) +
                        wg * 64 * 128;  // Q rows
    const uint32_t da = qa + S::own;    // dO rows
#pragma unroll
    for (int k = 0; k < D / 2; ++k) acc[k] = 0.f;
    hopper::mbar_wait(&bar.own_full[ob], (j >> 1) & 1);

    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % STAGES;
      hopper::mbar_wait(&bar.full[st], (ring / STAGES) & 1);
      if (it < n_mine) {
        const int k0 = it * BK;
        const uint32_t kb = hopper::smem_u32(smem + S::stage_off +
                                             st * 2 * S::stream);
        const uint32_t vb = kb + S::stream;
        const int* kst = reinterpret_cast<const int*>(smem + S::rows_off) +
                         st * 3 * STREAM + 2 * STREAM;
        // S = Q K^T, then dP = dO V^T, two groups: P starts when S is done
        hopper::wgmma_fence();
        mma_ss<D>(s, qa, kb);
        hopper::wgmma_commit();
        mma_ss<D>(dp, da, vb);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::reg_fence(s);
        // P = exp(S scale - lse), selected to 0 where the mask says no; the
        // test only in the tiles that cross the diagonal or an edge
        if (needs_mask(qw, k0, p)) {
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int c = (k / 4) * 8 + 2 * t + (k & 1);
            const bool hi = (k & 2) != 0;
            s[k] = visible(hi ? row1 : row0, k0 + c, hi ? qs1 : qs0,
                           sg ? kst[c] : 0, p)
                       ? exp2_ftz(s[k] * sl2 - (hi ? ll1 : ll0))
                       : 0.f;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 32; ++k)
            s[k] = exp2_ftz(s[k] * sl2 - ((k & 2) ? ll1 : ll0));
        }
        hopper::wgmma_wait<0>();
        hopper::reg_fence(dp);
        // dS = P (dP - delta) scale, rounded to K's type for dQ += dS K
#pragma unroll
        for (int k = 0; k < 32; ++k)
          s[k] = s[k] * (dp[k] - ((k & 2) ? dl1 : dl0)) * p.scale;
        to_a_frags(af, s);
        hopper::wgmma_fence();
        mma_rs<D>(acc, af, kb);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(acc);
        hopper::reg_fence(af);
      }
      release(&bar.empty[st]);
    }
    release(&bar.own_empty[ob]);  // Q, dO read for good
    ++j;

    bf16* dqg = at_mut<bf16>(p.dq, b, h, p.dq_sb, p.dq_sh);
    if (row0 < p.Sq)
      store_row<0>(dqg + (long long)row0 * p.dq_ss, acc, t);
    if (row1 < p.Sq)
      store_row<2>(dqg + (long long)row1 * p.dq_ss, acc, t);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_bf16(const __grid_constant__ Maps maps, const Params p,
                   int BH) {
  using S = Smem90<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  hopper::init_barriers<STAGES>(smem, S::bar_off);
  const Bars bar(smem, S::bar_off);
  // unit u: key tile u / BH (the low ones see the most queries) of
  // (batch, head) u % BH
  const int n_units = (p.Sk + OWN - 1) / OWN * BH;
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32;

  if (warp >= 8) {  // producer: K, V a unit ahead; Q, dO, lse, delta, ids
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > 8) return;
    for (int i = 0, j = 0, ring = 0; i * (int)gridDim.x < n_units; ++i) {
      const int u = nth_unit(i, n_units);
      if (u < 0) continue;
      const int bh = u % BH, b = bh / p.H, h = bh % p.H;
      const int k0 = u / BH * OWN, qt0 = first_query_tile(k0, p);
      produce_unit<D>(maps, smem, j++, ring, k0, qt0 * BQ,
                      max(0, n_q - qt0), p.Sq, h, b,
                      p.lse + (long long)bh * p.Sq,
                      p.delta + (long long)bh * p.Sq,
                      p.seg ? p.seg + (long long)b * p.Sk : nullptr);
    }
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4, w = warp % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * LOG2E;
  float dk[D / 2], dv[D / 2], s[32], dp[32];
  uint32_t pf[4][4], df[4][4];

  for (int i = 0, j = 0, ring = 0; i * (int)gridDim.x < n_units; ++i) {
    const int u = nth_unit(i, n_units);
    if (u < 0) continue;
    const int ob = j & 1;
    const int bh = u % BH, b = bh / p.H, h = bh % p.H;
    const int k0 = u / BH * OWN, qt0 = first_query_tile(k0, p);
    const int n_tiles = max(0, n_q - qt0);
    const int* sg = p.seg ? p.seg + (long long)b * p.Sk : nullptr;
    const int kw = k0 + wg * 64;  // this warpgroup's 64 keys
    const int key0 = kw + w * 16 + g, key1 = key0 + 8;  // this thread's
    const int ks0 = sg && key0 < p.Sk ? sg[key0] : -1;
    const int ks1 = sg && key1 < p.Sk ? sg[key1] : -1;
    const uint32_t ka = hopper::smem_u32(smem + ob * 2 * S::own) +
                        wg * 64 * 128;  // K rows
    const uint32_t va = ka + S::own;    // V rows
#pragma unroll
    for (int k = 0; k < D / 2; ++k) dk[k] = dv[k] = 0.f;
    hopper::mbar_wait(&bar.own_full[ob], (j >> 1) & 1);

    for (int it = 0; it < n_tiles; ++it, ++ring) {
      const int st = ring % STAGES;
      const int q0 = (qt0 + it) * BQ;
      hopper::mbar_wait(&bar.full[st], (ring / STAGES) & 1);
      // a warpgroup whose keys no query of the tile sees skips it
      if (kw < p.Sk && !(p.causal && kw > p.Sk - p.Sq + q0 + BQ - 1)) {
        const uint32_t qb = hopper::smem_u32(smem + S::stage_off +
                                             st * 2 * S::stream);
        const uint32_t db = qb + S::stream;
        const float* lst = reinterpret_cast<const float*>(
                               smem + S::rows_off) + st * 3 * STREAM;
        const float* dst = lst + STREAM;
        const int* qst = reinterpret_cast<const int*>(dst + STREAM);
        // S^T = K Q^T, then dP^T = V dO^T (64 keys x 64 queries)
        hopper::wgmma_fence();
        mma_ss<D>(s, ka, qb);
        hopper::wgmma_commit();
        mma_ss<D>(dp, va, db);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::reg_fence(s);
        // P^T (lst holds the lse of the tile's queries)
        if (needs_mask(q0, kw, p)) {
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int c = (k / 4) * 8 + 2 * t + (k & 1);  // query in tile
            const bool hi = (k & 2) != 0;
            s[k] = visible(q0 + c, hi ? key1 : key0, sg ? qst[c] : 0,
                           hi ? ks1 : ks0, p)
                       ? exp2_ftz(s[k] * sl2 - lst[c] * LOG2E)
                       : 0.f;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 32; ++k)
            s[k] = exp2_ftz(s[k] * sl2 -
                            lst[(k / 4) * 8 + 2 * t + (k & 1)] * LOG2E);
        }
        hopper::wgmma_wait<0>();
        hopper::reg_fence(dp);
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int c = (k / 4) * 8 + 2 * t + (k & 1);
          dp[k] = s[k] * (dp[k] - dst[c]) * p.scale;  // dS^T
        }
        // P^T rounded to dO's type, dS^T to Q's: the A operands, from
        // registers, of dV += P^T dO and dK += dS^T Q (dO, Q MN-major)
        to_a_frags(pf, s);
        to_a_frags(df, dp);
        hopper::wgmma_fence();
        mma_rs<D>(dv, pf, db);
        mma_rs<D>(dk, df, qb);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(dv);
        hopper::reg_fence(dk);
        hopper::reg_fence(pf);
        hopper::reg_fence(df);
      }
      release(&bar.empty[st]);
    }
    release(&bar.own_empty[ob]);  // K, V read for good
    ++j;

    bf16* dkg = at_mut<bf16>(p.dk, b, h, p.dk_sb, p.dk_sh);
    bf16* dvg = at_mut<bf16>(p.dv, b, h, p.dv_sb, p.dv_sh);
    if (key0 < p.Sk) {
      store_row<0>(dkg + (long long)key0 * p.dk_ss, dk, t);
      store_row<0>(dvg + (long long)key0 * p.dv_ss, dv, t);
    }
    if (key1 < p.Sk) {
      store_row<2>(dkg + (long long)key1 * p.dk_ss, dk, t);
      store_row<2>(dvg + (long long)key1 * p.dv_ss, dv, t);
    }
  }
}

// ------------------------------------------------------------- launching
// The Hopper kernels: the four TMA maps (own tiles with boxes of 128 rows,
// streamed ones of 64), the first launch's checks (hopper.cuh,
// prepare_persistent), and one persistent CTA an SM, or one a unit where
// there are fewer units.
template <int D, bool DKV>
cudaError_t launch_sm90(const Params& p, int bh, cudaStream_t stream) {
  static std::atomic<int> sms{0};
  auto kernel = DKV ? flash_dkv_bf16<D> : flash_dq_bf16<D>;
  const int B = bh / p.H;
  const int s_own = DKV ? p.Sk : p.Sq, s_str = DKV ? p.Sq : p.Sk;
  const void* own[2] = {DKV ? p.k : p.q, DKV ? p.v : p.dout};
  const void* str[2] = {DKV ? p.q : p.k, DKV ? p.dout : p.v};
  const long long so[2][3] = {
      {DKV ? p.k_ss : p.q_ss, DKV ? p.k_sh : p.q_sh, DKV ? p.k_sb : p.q_sb},
      {DKV ? p.v_ss : p.do_ss, DKV ? p.v_sh : p.do_sh,
       DKV ? p.v_sb : p.do_sb}};
  const long long ss[2][3] = {
      {DKV ? p.q_ss : p.k_ss, DKV ? p.q_sh : p.k_sh, DKV ? p.q_sb : p.k_sb},
      {DKV ? p.do_ss : p.v_ss, DKV ? p.do_sh : p.v_sh,
       DKV ? p.do_sb : p.v_sb}};
  Maps m;
  CUtensorMap* maps[4] = {&m.a, &m.b, &m.c, &m.e};
  for (int i = 0; i < 4; ++i) {
    const bool is_own = i < 2;
    const long long* st = is_own ? so[i] : ss[i - 2];
    const cudaError_t e = hopper::make_map_4d(
        maps[i], is_own ? own[i] : str[i - 2], D, is_own ? s_own : s_str,
        p.H, B, st[0], st[1], st[2], is_own ? OWN : STREAM);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = Smem90<D>::bytes;
  const cudaError_t e = hopper::prepare_persistent(kernel, smem, sms);
  if (e != cudaSuccess) return e;
  const long long units = (long long)(s_own + OWN - 1) / OWN * bh;
  const dim3 grid((unsigned)std::min<long long>(units, sms.load()));
  kernel<<<grid, THREADS, smem, stream>>>(m, p, bh);
  return cudaGetLastError();
}

// bf16 at d = 64 and 128 runs the Hopper kernels, bf16 at d = 16 and 32
// the mma.sync ones (a wgmma tile needs 64 columns), f32 the FMA ones;
// the choice is the shape's, never a failure's
template <int D>
cudaError_t launch_dq(const Params& p, bool is_bf16, int bh,
                      cudaStream_t stream) {
  static std::atomic<bool> bf16_ready{false}, f32_ready{false};
  const dim3 grid((p.Sq + BQ - 1) / BQ, bh);
  if (!is_bf16)
    return launch(flash_dq_f32<D>, LayoutF32<D>::bytes, f32_ready, p, grid,
                  stream);
  if constexpr (D >= 64)
    return launch_sm90<D, false>(p, bh, stream);
  else
    return launch(flash_dq_bf16_small<D>, LayoutBF16<D>::bytes, bf16_ready,
                  p, grid, stream);
}

template <int D>
cudaError_t launch_dkv(const Params& p, bool is_bf16, int bh,
                       cudaStream_t stream) {
  static std::atomic<bool> bf16_ready{false}, f32_ready{false};
  const dim3 grid((p.Sk + BK - 1) / BK, bh);
  if (!is_bf16)
    return launch(flash_dkv_f32<D>, LayoutF32<D>::bytes, f32_ready, p, grid,
                  stream);
  if constexpr (D >= 64)
    return launch_sm90<D, true>(p, bh, stream);
  else
    return launch(flash_dkv_bf16_small<D>, LayoutBF16<D>::bytes, bf16_ready,
                  p, grid, stream);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const int* seg, int heads, int sq, int sk, int causal,
                   float scale, const long long* st) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg = seg;
  p.dq = p.dk = p.dv = nullptr;
  p.H = heads;
  p.Sq = sq;
  p.Sk = sk;
  p.causal = causal;
  p.scale = scale;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.do_sb = st[9]; p.do_sh = st[10]; p.do_ss = st[11];
  return p;
}

typedef cudaError_t (*Launcher)(const Params&, bool, int, cudaStream_t);

int run(Params& p, int batch, int heads, int d, int is_bf16, int device,
        void* stream, Launcher l16, Launcher l32, Launcher l64,
        Launcher l128) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  if (p.seg && p.Sq != p.Sk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (d) {
    case 16: e = l16(p, is_bf16, bh, s); break;
    case 32: e = l32(p, is_bf16, bh, s); break;
    case 64: e = l64(p, is_bf16, bh, s); break;
    case 128: e = l128(p, is_bf16, bh, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`,
// allocates nothing, does not synchronise, and returns the cudaError_t of
// the launch. is_bf16: 0 = float32, 1 = bfloat16. `in_strides` holds the
// (batch, head, row) element strides of q, k, v and dout, 12 values;
// `out_strides` those of the outputs. lse and delta are (batch*heads, sq)
// contiguous f32; `seg` is null or (batch, sq) contiguous int32 segment
// ids (then sq == sk).
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const int* seg, void* dq, int batch, int heads,
                        int sq, int sk, int d, int is_bf16, int causal,
                        float scale, const long long* in_strides,
                        const long long* out_strides, int device,
                        void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, seg, heads, sq, sk,
                         causal, scale, in_strides);
  p.dq = dq;
  p.dq_sb = out_strides[0]; p.dq_sh = out_strides[1]; p.dq_ss = out_strides[2];
  return run(p, batch, heads, d, is_bf16, device, stream, launch_dq<16>,
             launch_dq<32>, launch_dq<64>, launch_dq<128>);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, const int* seg, void* dk,
                         void* dv, int batch, int heads, int sq, int sk,
                         int d, int is_bf16, int causal, float scale,
                         const long long* in_strides,
                         const long long* out_strides, int device,
                         void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, seg, heads, sq, sk,
                         causal, scale, in_strides);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = out_strides[0]; p.dk_sh = out_strides[1]; p.dk_ss = out_strides[2];
  p.dv_sb = out_strides[3]; p.dv_sh = out_strides[4]; p.dv_ss = out_strides[5];
  return run(p, batch, heads, d, is_bf16, device, stream, launch_dkv<16>,
             launch_dkv<32>, launch_dkv<64>, launch_dkv<128>);
}
