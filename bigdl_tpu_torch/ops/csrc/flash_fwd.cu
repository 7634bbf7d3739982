// Flash-attention forward for Hopper (sm_90a), f32 and bf16, head_dim 16..128.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// bigdl_tpu/ops/attention_kernel.py (reached through `_flash_fwd` and
// `pl.pallas_call`). It computes what that kernel computes, not its block
// schedule:
//
//   O   = softmax(Q K^T * d^-1/2, mask) V
//   lse = m + log(max(l, 1e-30))          (f32, one value per query row)
//
// The mask is the bottom-right causal triangle (q_offset = s_k - s_q: query
// i sees keys <= q_offset + i) and, for packed rows, the segment compare
// (`_block_valid`): a query sees only keys of its own segment id, so id-0
// padding rows attend id-0 keys and stay live. f32 running max m and sum
// l, P rounded to V's type before P@V, fully-future K tiles skipped, rows
// with no live key giving O = 0. Ragged s_q and s_k are masked here, at the
// tile edge.
//
// What bounds it on an H100: the work is ~s/4 FLOP per byte of Q/K/V/O
// at s keys (causal halves it), against the ~295 FLOP/byte at which the
// bf16 tensor cores and not HBM are the limit, so at s <= 1024 the floor is
// the bytes of Q, K, V and O with the products close behind (8 x 8 heads
// of 128, s = 1024, causal: 0.020 ms of bytes, 0.017 ms of products at
// 989 TFLOP/s). The (s_q, s_k) score matrix never reaches device memory,
// so device traffic is one read of Q, K, V and one write of O and lse;
// what is left is feeding the tensor cores.
//
// bf16 at d = 64 and 128, the Hopper kernel (flash_fwd_sm90): persistent
// CTAs, one an SM, walk 128-row query tiles heaviest first; a producer
// warpgroup TMA-loads Q a unit ahead and streams K and V tiles through
// mbarrier rings; two consumer warpgroups of 64 rows run S = Q K^T as
// wgmma from shared memory (both operands K-major), the online softmax in
// registers (one ex2.approx.ftz an entry, the mask only in tiles that
// cross the causal diagonal or the key edge, or with segments), and
// O += P V with P packed to bf16 from the S accumulator as the register A
// operand and V read MN-major. S of the next key tile (of the next unit,
// at a unit's end) is issued beside P V of this one, so the tensor cores
// work through the softmax.
//
// bf16 at d = 16 and 32 (flash_fwd_bf16): mma.sync m16n8k16, one CTA of 4
// warps per 64-row query tile, S, P and O in registers, K/V tiles double-
// buffered with cp.async, V transposed by ldmatrix. f32 (flash_fwd_f32):
// plain FMA (no TF32), so f32 results stay comparable to the f32 plain
// version; S, P and the accumulator live in shared memory. The choice is
// made by dtype and d (`hopper_kernel`, at the end). Not done yet (later
// work): splitting one query tile's key loop across CTAs for short queries.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // (B, S) segment ids, contiguous, or null; S = Sq = Sk
  void* o;
  float* lse;  // (B*H, Sq)
  int H, Sq, Sk, causal;
  float scale;
  // element strides of (batch, head, row); the last dim is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
};

// K tiles a causal query tile needs: those not wholly in the future of its
// last real query row
__device__ __forceinline__ int key_tiles(int q0, const Params& p) {
  int n = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int q_last = p.Sk - p.Sq + min(q0 + BQ, p.Sq) - 1;
    n = min(n, q_last < 0 ? 0 : q_last / BK + 1);
  }
  return n;
}

// =========================================================== f32: FMA path
template <int D> struct LayoutF32 {
  using L = F32<D>;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + 4 * BQ * L::LDT);
  static constexpr size_t v_off = align128(k_off + 4 * BK * L::LDT);
  static constexpr size_t s_off = align128(v_off + 4 * BK * L::LDT);
  static constexpr size_t o_off = align128(s_off + 4 * BQ * L::LDS);
  static constexpr size_t m_off = align128(o_off + 4 * BQ * L::LDO);
  static constexpr size_t l_off = m_off + 4 * BQ;
  static constexpr size_t qs_off = l_off + 4 * BQ;  // query segment ids
  static constexpr size_t ks_off = qs_off + 4 * BQ;  // key segment ids
  static constexpr size_t bytes = ks_off + 4 * BK;
};

// Warp w updates rows 16w..16w+15: mask, running max, P (over S in place),
// running sum, and the rescale of the output accumulator.
template <int D>
__device__ __forceinline__ void softmax_tile_f32(float* Ss, float* Os,
                                                 float* m_s, float* l_s,
                                                 const int* qs, const int* ks,
                                                 int q0, int k0,
                                                 const Params& p) {
  using L = F32<D>;
  const int q_offset = p.Sk - p.Sq;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool seg = p.seg != nullptr;
#pragma unroll 1
  for (int rr = 0; rr < 16; ++rr) {
    const int r = w * 16 + rr;
    const int c0 = k0 + lane, c1 = c0 + 32;
    bool v0 = live(c0, q0 + r, p.Sk, q_offset, p.causal);
    bool v1 = live(c1, q0 + r, p.Sk, q_offset, p.causal);
    if (seg) {
      v0 = v0 && ks[lane] == qs[r];
      v1 = v1 && ks[lane + 32] == qs[r];
    }
    const float s0 = v0 ? Ss[r * L::LDS + lane] : NEG_INF;
    const float s1 = v1 ? Ss[r * L::LDS + lane + 32] : NEG_INF;
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    const float p0 = v0 ? expf(s0 - m_new) : 0.f;
    const float p1 = v1 ? expf(s1 - m_new) : 0.f;
    float sum = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    const float corr = expf(m_old - m_new);
    Ss[r * L::LDS + lane] = p0;  // each lane overwrites only what it read
    Ss[r * L::LDS + lane + 32] = p1;
    for (int c = lane; c < D; c += 32) Os[r * L::LDO + c] *= corr;
    __syncwarp();  // every lane has read m_s[r] before lane 0 updates it
    if (lane == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * corr + sum;
    }
  }
}

// grid (ceil(Sq/64), B*H); one CTA per (batch*head, 64-row query tile)
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32(Params p) {
  using L = LayoutF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  int* qs = reinterpret_cast<int*>(smem + L::qs_off);
  int* ks = reinterpret_cast<int*>(smem + L::ks_off);

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* sg = p.seg ? p.seg + (long long)b * p.Sk : nullptr;

  load_tile_f32<D>(Qs, qg, q0, p.Sq, p.q_ss);
  if (sg) load_rows(qs, sg, q0, p.Sq, 0);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS)
    Os[(i / D) * F32<D>::LDO + i % D] = 0.f;
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }
  const int n_tiles = key_tiles(q0, p);
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    load_tile_f32<D>(Ks, kg, t * BK, p.Sk, p.k_ss);
    load_tile_f32<D>(Vs, vg, t * BK, p.Sk, p.v_ss);
    if (sg) load_rows(ks, sg, t * BK, p.Sk, -1);
    __syncthreads();
    mm_nt_f32<D>(Qs, Ks, Ss, p.scale);
    __syncthreads();
    softmax_tile_f32<D>(Ss, Os, m_s, l_s, qs, ks, q0, t * BK, p);
    __syncthreads();
    mm_acc_f32_smem<D>(Ss, Vs, Os);
    __syncthreads();
  }

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = w * 16 + rr;
    const int qi = q0 + r;
    if (qi >= p.Sq) break;
    const float l_safe = fmaxf(l_s[r], 1e-30f);
    float* orow = og + (long long)qi * p.o_ss;
    for (int c = lane; c < D; c += 32) orow[c] = Os[r * F32<D>::LDO + c] / l_safe;
    if (lane == 0) p.lse[(long long)bh * p.Sq + qi] = m_s[r] + logf(l_safe);
  }
}

// ================================================= bf16: tensor-core path
template <int D> struct LayoutBF16 {
  static constexpr int TILE = BF16<D>::TILE;
  // Q, then two stages of K, then two stages of V, then two stages of the
  // key tiles' segment ids
  static constexpr size_t ks_off = 5 * TILE * sizeof(bf16);
  static constexpr size_t bytes = ks_off + 2 * BK * sizeof(int);
};

// is key k0 + c visible to query `row` (segment id `qs`)? `ks` holds the
// key tile's segment ids, read only with SEG
template <bool SEG>
__device__ __forceinline__ bool visible(int k0, int c, int row,
                                        const int* ks, int qs,
                                        const Params& p) {
  return live(k0 + c, row, p.Sk, p.Sk - p.Sq, p.causal) &&
         (!SEG || ks[c] == qs);
}

// Online softmax over one 16 x 64 score tile held as n-block accumulators:
// scale, mask (when MASK), running max m and this thread's share of the
// running sum l of rows row0 and row0 + 8, the rescale factors of the
// output accumulator, and P = exp(S - m) in place. Each row's four lanes
// (t = 0..3) reduce by shuffles. With SEG, `ks` holds the tile's key
// segment ids and qs0, qs1 the rows' ids.
template <bool MASK, bool SEG>
__device__ __forceinline__ void softmax_update(float (&s)[BK / 8][4],
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& corr0, float& corr1,
                                               int k0, int row0, int t,
                                               const int* ks, int qs0,
                                               int qs1, const Params& p) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 8 + 2 * t + e;
      s[j][e] = !MASK || visible<SEG>(k0, c, row0, ks, qs0, p)
                    ? s[j][e] * p.scale : NEG_INF;
      s[j][2 + e] = !MASK || visible<SEG>(k0, c, row0 + 8, ks, qs1, p)
                        ? s[j][2 + e] * p.scale : NEG_INF;
      mx0 = fmaxf(mx0, s[j][e]);
      mx1 = fmaxf(mx1, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  corr0 = exp2f((m0 - mn0) * LOG2E);
  corr1 = exp2f((m1 - mn1) * LOG2E);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 8 + 2 * t + e;
      s[j][e] = !MASK || visible<SEG>(k0, c, row0, ks, qs0, p)
                    ? exp2f((s[j][e] - mn0) * LOG2E) : 0.f;
      s[j][2 + e] = !MASK || visible<SEG>(k0, c, row0 + 8, ks, qs1, p)
                        ? exp2f((s[j][2 + e] - mn1) * LOG2E) : 0.f;
      sum0 += s[j][e];
      sum1 += s[j][2 + e];
    }
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
}

// SEG: p.seg is set (packed rows); a separate instantiation, so the
// kernel without segments carries none of their work
template <int D, bool SEG>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_bf16(Params p) {
  using L = LayoutBF16<D>;
  constexpr int LDT = BF16<D>::LDT;
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NO = D / 8;   // n-blocks of the output
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::TILE;      // stages at Ks, Ks + TILE
  bf16* Vs = Qs + 3 * L::TILE;  // stages at Vs, Vs + TILE
  int* kseg = reinterpret_cast<int*>(smem + L::ks_off);  // stages of BK ids

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* sg = SEG ? p.seg + (long long)b * p.Sk : nullptr;

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + w * 16 + g, row1 = row0 + 8;  // this thread's rows
  const int q_offset = p.Sk - p.Sq;
  const int n_tiles = key_tiles(q0, p);
  const int qs0 = SEG && row0 < p.Sq ? sg[row0] : 0;
  const int qs1 = SEG && row1 < p.Sq ? sg[row1] : 0;

  load_tile_bf16<D>(Qs, qg, q0, p.Sq, p.q_ss);
  if (n_tiles > 0) {
    load_tile_bf16<D>(Ks, kg, 0, p.Sk, p.k_ss);
    load_tile_bf16<D>(Vs, vg, 0, p.Sk, p.v_ss);
    if (SEG) load_rows(kseg, sg, 0, p.Sk, -1);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4];  // this warp's 16 query rows as A fragments, by
                       // plain 32-bit loads (the compiler may reload them)
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* q = Qs + (w * 16 + g) * LDT + kk * 16 + 2 * t;
    qf[kk][0] = ld32(q);
    qf[kk][1] = ld32(q + 8 * LDT);
    qf[kk][2] = ld32(q + 8);
    qf[kk][3] = ld32(q + 8 * LDT + 8);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows row0, row1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {  // prefetch the next K/V tile
      load_tile_bf16<D>(Ks + (st ^ 1) * L::TILE, kg, (tile + 1) * BK, p.Sk,
                        p.k_ss);
      load_tile_bf16<D>(Vs + (st ^ 1) * L::TILE, vg, (tile + 1) * BK, p.Sk,
                        p.v_ss);
      if (SEG) load_rows(kseg + (st ^ 1) * BK, sg, (tile + 1) * BK, p.Sk, -1);
    }
    cp_async_commit();
    const bf16* Kt = Ks + st * L::TILE;
    const bf16* Vt = Vs + st * L::TILE;
    const int k0 = tile * BK;

    // S = Q K^T for 16 rows x 64 keys: 8 n-blocks of 8 keys. K^T as the
    // column-major B operand is K's rows as they lie, so one ldmatrix
    // gives b0, b1 of key blocks j and j+1
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* kr = Kt + b_frag_offset(lane, LDT);
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kr + j * 8 * LDT + kk * 16);
        mma_bf16(s[j], qf[kk], kb[0], kb[1]);
        mma_bf16(s[j + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // online softmax; without segments only tiles that cross the causal
    // diagonal or the ragged key edge pay for the mask
    float corr0, corr1;
    const int* kst = kseg + st * BK;
    if (SEG || k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q_offset + q0))
      softmax_update<true, SEG>(s, m0, m1, l0, l1, corr0, corr1, k0, row0, t,
                                kst, qs0, qs1, p);
    else
      softmax_update<false, SEG>(s, m0, m1, l0, l1, corr0, corr1, k0, row0,
                                 t, kst, qs0, qs1, p);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V: the score accumulator of key blocks 2kk, 2kk+1 is the A
    // fragment of key step kk, rounded to bf16
    const bf16* vr = Vt + bt_frag_offset(lane, LDT);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4];
      c_to_a(pf, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + kk * 16 * LDT + n * 8);
        mma_bf16(acc[n], pf, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pf, vb[2], vb[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... and no warp still reads this one
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
  }
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  if (row0 < p.Sq) {
    bf16* orow = og + (long long)row0 * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][0] / ls0, acc[n][1] / ls0);
    if (t == 0) p.lse[(long long)bh * p.Sq + row0] = m0 + logf(ls0);
  }
  if (row1 < p.Sq) {
    bf16* orow = og + (long long)row1 * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2] / ls1, acc[n][3] / ls1);
    if (t == 0) p.lse[(long long)bh * p.Sq + row1] = m1 + logf(ls1);
  }
}

// ============================== bf16, d = 64 and 128: Hopper (wgmma, TMA)
// Persistent warp-specialised CTAs (hopper.cuh). A unit is one 128-row
// query tile of one (batch, head); consumer warpgroup wg owns its rows
// 64 wg .. 64 wg + 63. The producer warp TMA-loads the unit's Q into one
// of two buffers, a unit ahead, and streams K and V tiles of KT keys
// through two rings of STAGES stages each (the key tile's segment ids by
// cp.async beside K). A consumer issues S = Q K^T of tile j+1 and
// O += P V of tile j together, and runs the softmax of tile j+1 while the
// tensor cores work on both, so a K stage is free once its S is done and a
// V stage once its P V is. The pipeline runs on across units: P V of a
// unit's last tile goes with S of the next unit's first, so no unit starts
// or ends with the tensor cores waiting on one product alone.
//
// KT and the stages are chosen by shared memory (227 KB a CTA): at d = 128
// two Q buffers take 64 KB, and 128-key tiles in two stages of K and two
// of V 128 KB. 64-key tiles in four stages fit the same room and were
// slower at every shape measured (PERF.md).
//
// The two consumer warpgroups take turns at issuing their products (FA3's
// ping-pong: one warpgroup's softmax runs while the other's products do),
// through two mbarriers; without the turns the kernel was slower at every
// shape measured (PERF.md).
using hopper::align1024;
using hopper::CONSUMER_REGS;
using hopper::exp2_ftz;
using hopper::Maps;
using hopper::nth_unit;
using hopper::PRODUCER_REGS;
using hopper::release;
using hopper::THREADS;
using hopper::tma_tile;
constexpr int UNIT = 128;                   // query rows of a unit
constexpr int KT = 128;                     // keys of a streamed tile
constexpr int STAGES = 2;                   // of K, and as many of V
// ring slot 2s holds stage s of K, slot 2s + 1 stage s of V
using Bars = hopper::Bars<2 * STAGES>;

template <int D> struct Smem90 {
  static constexpr uint32_t q = UNIT * D * 2;  // bytes of a Q tile
  static constexpr uint32_t kv = KT * D * 2;   // of a K or V tile
  // two Q buffers, the K stages, the V stages (tiles 1024-byte aligned),
  // the key tiles' segment ids, the barriers
  static constexpr uint32_t k_off = 2 * q;
  static constexpr uint32_t v_off = k_off + STAGES * kv;
  static constexpr uint32_t seg_off = v_off + STAGES * kv;
  static constexpr uint32_t bar_off = seg_off + STAGES * KT * 4;
  static constexpr uint32_t turn_off = bar_off + Bars::bytes;
  static constexpr uint32_t bytes = turn_off + 2 * 8 + 1024;
  static_assert(bytes <= 232448, "over the 227 KB a CTA can have");
};

// Warpgroup wg waits for its turn on bar[wg] before it issues products and
// passes the turn on bar[wg ^ 1] after. Each warpgroup takes one turn per
// key tile of every unit, computed or skipped, and the final P V in flush()
// takes none; that equal count is what keeps the turns strictly
// alternating.
struct Turns {
  uint64_t* bar;
  int wg, n;
  __device__ __forceinline__ void take() {
    hopper::mbar_wait(&bar[wg], n & 1);
  }
  __device__ __forceinline__ void pass() {
    release(&bar[wg ^ 1]);
    ++n;
  }
};

// does a warpgroup's 64 query rows from qw need the per-element mask in
// the key tile at k0? (segments, the ragged key edge: TMA fills keys past
// Sk with zeros, which score 0, not -inf; the causal diagonal)
template <bool SEG>
__device__ __forceinline__ bool needs_mask90(int qw, int k0,
                                             const Params& p) {
  return SEG || k0 + KT > p.Sk ||
         (p.causal && k0 + KT - 1 > p.Sk - p.Sq + qw);
}

// The online softmax of one 64 x KT score tile in a warpgroup's
// accumulator layout (hopper.cuh): entry k of a thread is row g (k & 2 ==
// 0) or g + 8 of its warp's 16, column 8 (k / 4) + 2t + (k & 1). Scores
// the mask hides become -inf, so their exponentials are 0 without a second
// test. m0, m1 are the rows' running maxima of the raw scores (-1e30
// before any live key, so no inf - inf arises), l0, l1 this thread's share
// of the running sums; corr0, corr1 the factors that rescale O. The scale
// and log2(e) fold into one multiply: P = 2^(S sl2 - m sl2).
template <bool MASK, bool SEG>
__device__ __forceinline__ void softmax90(float (&s)[KT / 2], float& m0,
                                          float& m1, float& l0, float& l1,
                                          float& corr0, float& corr1,
                                          int k0, int row0, int t,
                                          const int* kst, int qs0, int qs1,
                                          float sl2, const Params& p) {
  if (MASK) {
#pragma unroll
    for (int k = 0; k < KT / 2; ++k) {
      const int c = (k / 4) * 8 + 2 * t + (k & 1);
      const bool hi = (k & 2) != 0;
      if (!visible<SEG>(k0, c, hi ? row0 + 8 : row0, kst, hi ? qs1 : qs0, p))
        s[k] = -INFINITY;
    }
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int k = 0; k < KT / 2; ++k) {
    if (k & 2)
      mx1 = fmaxf(mx1, s[k]);
    else
      mx0 = fmaxf(mx0, s[k]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  corr0 = exp2_ftz((m0 - mn0) * sl2);
  corr1 = exp2_ftz((m1 - mn1) * sl2);
  m0 = mn0;
  m1 = mn1;
  const float ms0 = mn0 * sl2, ms1 = mn1 * sl2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int k = 0; k < KT / 2; ++k) {
    if (k & 2) {
      s[k] = exp2_ftz(fmaf(s[k], sl2, -ms1));
      sum1 += s[k];
    } else {
      s[k] = exp2_ftz(fmaf(s[k], sl2, -ms0));
      sum0 += s[k];
    }
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
}

// s (64 x KT) = Q (64 rows of a Q tile at `q`) K^T (a K tile at `k`), both
// K-major over the head dim
template <int D>
__device__ __forceinline__ void mma_qk(float (&s)[KT / 2], uint32_t q,
                                       uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss_n128(s, hopper::kmajor_desc(q, UNIT, kk),
                          hopper::kmajor_desc(k, KT, kk), kk > 0);
}

// o (64 x D) += P (64 x KT, register k-steps) V (a V tile at `v`, MN-major)
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const uint32_t (&pf)[KT / 16][4],
                                       uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    if constexpr (D == 128)
      hopper::wgmma_rs_n128_tb(o, pf[kk], hopper::mnmajor_desc(v, KT, kk));
    else
      hopper::wgmma_rs_n64_tb(o, pf[kk], hopper::mnmajor_desc(v, KT, kk));
  }
}

// P rounded to bf16, as the register A operand of P V: k-step kk is the
// accumulator's n-blocks 2kk, 2kk + 1
__device__ __forceinline__ void pack_p(uint32_t (&pf)[KT / 16][4],
                                       const float (&s)[KT / 2]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pf[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// KT-key tiles the query rows < q_end need, fully-future tiles left out
// under causal
__device__ __forceinline__ int key_tiles90(int q_end, const Params& p) {
  int n = (p.Sk + KT - 1) / KT;
  if (p.causal) {
    const int q_last = p.Sk - p.Sq + q_end - 1;
    n = min(n, q_last < 0 ? 0 : q_last / KT + 1);
  }
  return n;
}

// where a warpgroup's unit goes: b * H + h, and this thread's first row
// (the other is row0 + 8)
struct Out {
  int bh, row0;
};

// O = acc / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30)) of this
// thread's two rows; a row with no live key (l = 0) gives O = 0 and the
// plain version's -1e30. Rows past Sq are not written.
template <int D>
__device__ __forceinline__ void store_out(const Params& p, const Out& u,
                                          const float (&o)[D / 2], float m0,
                                          float m1, float l0, float l1,
                                          int t) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
  }
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  bf16* og = static_cast<bf16*>(p.o) + (u.bh / p.H) * p.o_sb +
             (u.bh % p.H) * p.o_sh;
  if (u.row0 < p.Sq) {
    bf16* orow = og + (long long)u.row0 * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (t == 0)
      p.lse[(long long)u.bh * p.Sq + u.row0] =
          (l0 > 0.f ? m0 * p.scale : NEG_INF) + logf(ls0);
  }
  if (u.row0 + 8 < p.Sq) {
    bf16* orow = og + (long long)(u.row0 + 8) * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    if (t == 0)
      p.lse[(long long)u.bh * p.Sq + u.row0 + 8] =
          (l1 > 0.f ? m1 * p.scale : NEG_INF) + logf(ls1);
  }
}

template <int D, bool SEG>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90(const __grid_constant__ Maps maps, const Params p,
                   int BH) {
  using S = Smem90<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* turn_bars = reinterpret_cast<uint64_t*>(smem + S::turn_off);
  if (threadIdx.x == 0) {                  // a consumer warpgroup's
    hopper::mbar_init(&turn_bars[0], 4);   // warps pass a turn
    hopper::mbar_init(&turn_bars[1], 4);
  }
  hopper::init_barriers<2 * STAGES>(smem, S::bar_off);
  const Bars bar(smem, S::bar_off);
  int* kseg = reinterpret_cast<int*>(smem + S::seg_off);  // stage s: KT ids
  // unit u: query tile n_qt - 1 - u / BH (the high ones see the most keys)
  // of (batch, head) u % BH
  const int n_qt = (p.Sq + UNIT - 1) / UNIT, n_units = n_qt * BH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= 8) {  // producer: Q a unit ahead; K, V and the key ids
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > 8) return;
    for (int i = 0, j = 0, ring = 0; i * (int)gridDim.x < n_units; ++i) {
      const int u = nth_unit(i, n_units);
      if (u < 0) continue;
      const int bh = u % BH, b = bh / p.H, h = bh % p.H;
      const int q0 = (n_qt - 1 - u / BH) * UNIT;
      const int n = key_tiles90(min(q0 + UNIT, p.Sq), p);
      const int* sg = SEG ? p.seg + (long long)b * p.Sk : nullptr;
      const int ob = j & 1;
      hopper::mbar_wait(&bar.own_empty[ob], ((j >> 1) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&bar.own_full[ob], S::q);
        tma_tile<D>(smem + ob * S::q, &maps.a, &bar.own_full[ob], q0, h, b,
                    UNIT);
      }
      for (int it = 0; it < n; ++it, ++ring) {
        const int st = ring % STAGES, par = ((ring / STAGES) & 1) ^ 1;
        const int k0 = it * KT;
        hopper::mbar_wait(&bar.empty[2 * st], par);
        if (lane == 0) {  // the tile first: the ids load meanwhile
          hopper::mbar_expect_tx(&bar.full[2 * st], S::kv);
          tma_tile<D>(smem + S::k_off + st * S::kv, &maps.c,
                      &bar.full[2 * st], k0, h, b, KT);
        }
        if (SEG) {
          for (int c = lane; c < KT; c += 32) {
            const bool in = k0 + c < p.Sk;
            hopper::cp_async4(kseg + st * KT + c, sg + (in ? k0 + c : 0), in);
          }
        }
        hopper::cp_async_arrive(&bar.full[2 * st]);
        hopper::mbar_wait(&bar.empty[2 * st + 1], par);
        if (lane == 0) {
          hopper::mbar_expect_tx(&bar.full[2 * st + 1], S::kv);
          tma_tile<D>(smem + S::v_off + st * S::kv, &maps.e,
                      &bar.full[2 * st + 1], k0, h, b, KT);
        }
        hopper::mbar_arrive(&bar.full[2 * st + 1]);
      }
      ++j;
    }
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4, w = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * LOG2E;
  const uint32_t k_base = hopper::smem_u32(smem + S::k_off);
  const uint32_t v_base = hopper::smem_u32(smem + S::v_off);
  float o[D / 2], s[KT / 2];
  uint32_t pf[KT / 16][4];
  Turns turns{turn_bars, wg, 0};
  if (wg == 1) release(&turn_bars[0]);  // 0 goes first
  // The pipeline runs on from unit to unit: P of a unit's last key tile
  // waits in pf and is multiplied by V in the same stage as S of the next
  // unit's first tile, and the unit's output is stored once that stage is
  // done. m, l are the running max and sum of the unit being computed; om,
  // ol those of the unit whose output is pending (`out`).
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, corr0, corr1;
  float om0 = 0.f, om1 = 0.f, ol0 = 0.f, ol1 = 0.f;
  bool have_p = false;  // pf holds P whose P V is not issued yet ...
  int pv_r = 0;         // ... of this ring tile
  Out out{};            // the rows that P belongs to
#pragma unroll
  for (int k = 0; k < D / 2; ++k) o[k] = 0.f;

  // The last P V alone, and its unit's output (before a warpgroup skips
  // tiles, so that no V stage is held across them, and at the end).
  auto flush = [&]() {
    const int sp = pv_r % STAGES;
    hopper::mbar_wait(&bar.full[2 * sp + 1], (pv_r / STAGES) & 1);
    hopper::wgmma_fence();
    mma_pv<D>(o, pf, v_base + sp * S::kv);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(o);
    hopper::reg_fence(pf);
    release(&bar.empty[2 * sp + 1]);
    store_out<D>(p, out, o, m0, m1, l0, l1, t);
#pragma unroll
    for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
    have_p = false;
  };

  for (int i = 0, j = 0, ring = 0; i * (int)gridDim.x < n_units; ++i) {
    const int u = nth_unit(i, n_units);
    if (u < 0) continue;
    const int ob = j & 1;
    const int bh = u % BH, b = bh / p.H;
    const int q0 = (n_qt - 1 - u / BH) * UNIT;
    const int n_tiles = key_tiles90(min(q0 + UNIT, p.Sq), p);
    const int qw = q0 + wg * 64;  // this warpgroup's 64 query rows
    const int n_mine = qw < p.Sq ? key_tiles90(min(qw + 64, p.Sq), p) : 0;
    const Out unit{bh, qw + w * 16 + g};  // rows row0, row0 + 8
    // rows past Sq read 0 and compute values that are never stored
    const int* sg = SEG ? p.seg + (long long)b * p.Sk : nullptr;
    const int qs0 = SEG && unit.row0 < p.Sq ? sg[unit.row0] : 0;
    const int qs1 = SEG && unit.row0 + 8 < p.Sq ? sg[unit.row0 + 8] : 0;
    const uint32_t qa = hopper::smem_u32(smem + ob * S::q) + wg * 64 * 128;
    hopper::mbar_wait(&bar.own_full[ob], (j >> 1) & 1);

    // Between a wgmma and its wait there is no branch around an
    // instruction (waits come first, arrivals are predicated): ptxas
    // serializes every wgmma of a kernel that has one.
    for (int it = 0; it < n_mine; ++it) {
      const int r = ring + it, st = r % STAGES;
      const int k0 = it * KT;
      const int* kst = kseg + st * KT;
      const bool mask = needs_mask90<SEG>(qw, k0, p);
      if (it == 0) {  // a new unit: its stats start afresh
        om0 = m0; om1 = m1; ol0 = l0; ol1 = l1;
        m0 = m1 = NEG_INF;
        l0 = l1 = 0.f;
      }
      hopper::mbar_wait(&bar.full[2 * st], (r / STAGES) & 1);
      if (have_p) {  // S of this tile, and P V of the last one beside it
        const int sp = pv_r % STAGES;
        hopper::mbar_wait(&bar.full[2 * sp + 1], (pv_r / STAGES) & 1);
        turns.take();
        hopper::wgmma_fence();
        mma_qk<D>(s, qa, k_base + st * S::kv);
        hopper::wgmma_commit();
        mma_pv<D>(o, pf, v_base + sp * S::kv);
        hopper::wgmma_commit();
        turns.pass();
        // with segments, P V is waited for here too, so that pf is free
        // through the softmax: its registers are what the ids need
        hopper::wgmma_wait<SEG ? 0 : 1>();
        hopper::reg_fence(s);
        if (SEG) {
          hopper::reg_fence(o);
          hopper::reg_fence(pf);
        }
        if (mask)
          softmax90<true, SEG>(s, m0, m1, l0, l1, corr0, corr1, k0,
                               unit.row0, t, kst, qs0, qs1, sl2, p);
        else
          softmax90<false, SEG>(s, m0, m1, l0, l1, corr0, corr1, k0,
                                unit.row0, t, kst, qs0, qs1, sl2, p);
        release(&bar.empty[2 * st]);  // K and its segment ids read
        hopper::wgmma_wait<0>();
        if (!SEG) {
          hopper::reg_fence(o);
          hopper::reg_fence(pf);
        }
        release(&bar.empty[2 * sp + 1]);  // V of the last tile read
        if (it == 0) {  // the last unit is done: its output, a fresh O
          store_out<D>(p, out, o, om0, om1, ol0, ol1, t);
#pragma unroll
          for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
        } else {
#pragma unroll
          for (int k = 0; k < D / 2; ++k) o[k] *= (k & 2) ? corr1 : corr0;
        }
      } else {  // S alone: the first tile this warpgroup computes
        turns.take();
        hopper::wgmma_fence();
        mma_qk<D>(s, qa, k_base + st * S::kv);
        hopper::wgmma_commit();
        turns.pass();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(s);
        if (mask)
          softmax90<true, SEG>(s, m0, m1, l0, l1, corr0, corr1, k0,
                               unit.row0, t, kst, qs0, qs1, sl2, p);
        else
          softmax90<false, SEG>(s, m0, m1, l0, l1, corr0, corr1, k0,
                                unit.row0, t, kst, qs0, qs1, sl2, p);
        release(&bar.empty[2 * st]);
      }
      pack_p(pf, s);
      have_p = true;
      pv_r = r;
      out = unit;
    }
    // tiles the other warpgroup's rows need and these do not; rows that
    // see no key at all give O = 0 (o is 0 after a flush)
    if (have_p && (n_mine < n_tiles || n_mine == 0)) flush();
    if (n_mine == 0) store_out<D>(p, unit, o, NEG_INF, NEG_INF, 0.f, 0.f, t);
    for (int it = n_mine; it < n_tiles; ++it) {
      const int r = ring + it, st = r % STAGES;
      hopper::mbar_wait(&bar.full[2 * st], (r / STAGES) & 1);
      release(&bar.empty[2 * st]);
      hopper::mbar_wait(&bar.full[2 * st + 1], (r / STAGES) & 1);
      release(&bar.empty[2 * st + 1]);
      turns.take();
      turns.pass();
    }
    ring += n_tiles;
    release(&bar.own_empty[ob]);  // Q read for good
    ++j;
  }
  if (have_p) flush();
}

// ------------------------------------------------------------- launching
// The shape rule: bf16 at d = 64 and 128 runs the Hopper kernel, bf16 at
// d = 16 and 32 the mma.sync one (a wgmma k-step of a 128-byte swizzled
// tile wants 64 columns), f32 the FMA one. The choice is the shape's,
// never a failure's; flash_fwd_kernel names it. No sequence length keeps
// the mma.sync kernel at d = 64 and 128: the Hopper one was as fast or
// faster at every length measured, s_q = 16 and s = 128 among them
// (PERF.md).
constexpr bool hopper_kernel(int d) { return d >= 64; }

// The Hopper kernel: the three TMA maps (Q in boxes of 128 rows, K and V
// of KT), the first launch's checks (hopper.cuh, prepare_persistent), and
// one persistent CTA an SM, or one a unit where there are fewer units.
template <int D, bool SEG>
cudaError_t launch_sm90(const Params& p, int bh, cudaStream_t stream) {
  static std::atomic<int> sms{0};
  auto kernel = flash_fwd_sm90<D, SEG>;
  const int B = bh / p.H;
  Maps m{};  // b is unused: Q is the forward's only own tile
  cudaError_t e = hopper::make_map_4d(&m.a, p.q, D, p.Sq, p.H, B, p.q_ss,
                                      p.q_sh, p.q_sb, UNIT);
  if (e == cudaSuccess)
    e = hopper::make_map_4d(&m.c, p.k, D, p.Sk, p.H, B, p.k_ss, p.k_sh,
                            p.k_sb, KT);
  if (e == cudaSuccess)
    e = hopper::make_map_4d(&m.e, p.v, D, p.Sk, p.H, B, p.v_ss, p.v_sh,
                            p.v_sb, KT);
  const size_t smem = Smem90<D>::bytes;
  if (e == cudaSuccess) e = hopper::prepare_persistent(kernel, smem, sms);
  if (e != cudaSuccess) return e;
  const long long units = (long long)(p.Sq + UNIT - 1) / UNIT * bh;
  const dim3 grid((unsigned)std::min<long long>(units, sms.load()));
  kernel<<<grid, THREADS, smem, stream>>>(m, p, bh);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, bool is_bf16, int bh,
                     cudaStream_t stream) {
  static std::atomic<bool> bf16_ready{false}, bf16_seg_ready{false},
      f32_ready{false};
  const dim3 grid((p.Sq + BQ - 1) / BQ, bh);
  if (!is_bf16)
    return launch(flash_fwd_f32<D>, LayoutF32<D>::bytes, f32_ready, p, grid,
                  stream);
  if constexpr (hopper_kernel(D))
    return p.seg ? launch_sm90<D, true>(p, bh, stream)
                 : launch_sm90<D, false>(p, bh, stream);
  else
    return p.seg ? launch(flash_fwd_bf16<D, true>, LayoutBF16<D>::bytes,
                          bf16_seg_ready, p, grid, stream)
                 : launch(flash_fwd_bf16<D, false>, LayoutBF16<D>::bytes,
                          bf16_ready, p, grid, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, allocates
// nothing, does not synchronise; returns the cudaError_t of the launch.
// is_bf16: 0 = float32, 1 = bfloat16. Strides are in elements. `seg` is
// null or (batch, sq) contiguous int32 segment ids (then sq == sk).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* seg, void* o, void* lse, int batch,
                         int heads, int sq, int sk, int d, int is_bf16,
                         int causal, float scale, long long q_sb,
                         long long q_sh, long long q_ss, long long k_sb,
                         long long k_sh, long long k_ss, long long v_sb,
                         long long v_sh, long long v_ss, long long o_sb,
                         long long o_sh, long long o_ss, int device,
                         void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  if (seg && sq != sk) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = seg;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = heads;
  p.Sq = sq;
  p.Sk = sk;
  p.causal = causal;
  p.scale = scale;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (d) {
    case 16: e = launch_d<16>(p, is_bf16, bh, s); break;
    case 32: e = launch_d<32>(p, is_bf16, bh, s); break;
    case 64: e = launch_d<64>(p, is_bf16, bh, s); break;
    case 128: e = launch_d<128>(p, is_bf16, bh, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

// The name of the kernel flash_fwd launches at head dim d, by the rule
// above: "flash_fwd_sm90" (wgmma, TMA), "flash_fwd_bf16" (mma.sync) or
// "flash_fwd_f32".
extern "C" const char* flash_fwd_kernel(int d, int is_bf16) {
  if (!is_bf16) return "flash_fwd_f32";
  return hopper_kernel(d) ? "flash_fwd_sm90" : "flash_fwd_bf16";
}
