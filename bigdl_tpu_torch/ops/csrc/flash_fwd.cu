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
// What bounds it on an H100: at the serving prefill shapes (one prompt,
// 8 heads of 128, s <= 1024) the work is ~s/4 FLOP per byte of Q/K/V/O,
// under the ~295 FLOP/byte at which the bf16 tensor cores and not HBM
// would be the limit, so the floor is the bytes of Q, K, V and O; at
// s = 1024 the two are close. The (s_q, s_k) score matrix never reaches
// device memory: one CTA owns a 64-row query tile (16 rows a warp) and
// streams 64-row K/V tiles through shared memory, so device traffic is
// one read of Q, K, V and one write of O and lse.
//
// bf16: tensor cores through mma.sync m16n8k16 with f32 accumulation.
// Scores, probabilities and the output accumulator stay in registers (the
// score accumulator's layout is the A-operand layout of P@V, so P never
// goes to shared memory); K/V tiles are double-buffered with cp.async so
// the next tile loads while this one computes; V is fed to the tensor
// cores transposed by ldmatrix. Without segments, only tiles that cross
// the causal diagonal or the ragged key edge pay for the mask; with
// segments every tile compares ids. f32: plain FMA (no TF32), so f32
// results stay comparable to the f32 plain version; S, P and the
// accumulator live in shared memory. Not done yet (later work): wgmma and
// TMA, warp specialisation, splitting one query tile's key loop across
// CTAs for short queries.

#include "flash_common.cuh"

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

template <int D>
cudaError_t launch_d(const Params& p, bool is_bf16, int bh,
                     cudaStream_t stream) {
  static std::atomic<bool> bf16_ready{false}, bf16_seg_ready{false},
      f32_ready{false};
  const dim3 grid((p.Sq + BQ - 1) / BQ, bh);
  if (!is_bf16)
    return launch(flash_fwd_f32<D>, LayoutF32<D>::bytes, f32_ready, p, grid,
                  stream);
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
