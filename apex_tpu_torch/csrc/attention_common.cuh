// Exact softmax attention for Hopper (sm_90a): the forward and the
// backward device code that the short and the mid attention entries share.
//
// Replaces, through the C entries that include this header:
//   apex_tpu/ops/attention_short.py::_short_fwd_kernel, ::_short_bwd_kernel
//     (csrc/attention_short.cu: short_fwd, short_bwd);
//   apex_tpu/ops/attention_mid.py::_mid_fwd_kernel, ::_mid_bwd_kernel
//     (csrc/attention_mid.cu: mid_fwd, mid_bwd).
// The TPU kernels differ in how they use VMEM (the short ones hold a whole
// s <= 512 sequence, the mid ones stream k-blocks with a sequential grid
// axis); here both rungs compute the same function the same way, so they
// run one set of kernels behind separate entries, counters and checks.
//
// Forward: bf16 and fp16 inputs run the Hopper kernel of attention_fwd_sm90.cuh
// (TMA, a producer warp and consumer warpgroups, wgmma with the scores and
// the output in registers), in this rung's rounding order, s = (q . k) *
// scale.  fp32 inputs run attn_fwd_kernel below: one block per
// (batch*head, 64-row query tile) loops over 64-key K/V tiles with an
// online softmax (running max m, running sum l, rescaled accumulator).
// Both skip key tiles wholly above the causal diagonal, which is the TPU
// mid kernel's causal block skip.  Outputs: O in the input dtype and the
// row logsumexp lse (fp32) that the backward replays.
//
// Backward: the TPU kernels accumulate dQ over a sequential grid axis in
// VMEM (attention_mid.py:412); CUDA blocks run in no order, so the
// backward is three deterministic launches and no atomics:
//   1. attn_delta_kernel: delta = rowsum(dO * O) - dlse, one warp per row
//      (the JAX wrapper computes rowsum(dO * O) in XLA; folding the lse
//      cotangent in here turns dz = p * (dp - delta + dlse) into
//      dz = p * (dp - delta'), one formula for both entries);
//   2. a dK/dV kernel: one block per (batch*head, key tile).  It walks the
//      query tiles from the causal diagonal down, recomputes
//      s = (q . k) * scale and p = exp(s - lse), and accumulates
//      dV += p^T dO and dK += (dz * scale)^T Q;
//   3. a dQ kernel: one block per (batch*head, query tile).  It walks the
//      key tiles up to the diagonal and accumulates dQ += (dz * scale) K.
// bf16 and fp16 inputs run the Hopper kernels of attention_bwd_sm90.cuh
// (sm90::bwd_dkv_kernel, sm90::bwd_dq_kernel: TMA, a producer warpgroup
// and consumer warpgroups, wgmma with every tile product in registers,
// p and dz * scale rounded to bf16 or fp16 as their operands, where the TPU's
// default precision rounds them); fp32 inputs run attn_bwd_dkv_kernel and
// attn_bwd_dq_kernel below.  Both the forward and the backward scale the
// product, s = (q . k) * scale, as _short_fwd_kernel (:176) and
// _short_bwd_kernel (:256) do.
//
// The fp32 kernels have 4 warps, and each warp owns 16 rows of its block's
// tile end to end (its slice of every product and its softmax rows); only
// tile loads are shared, so the warps synchronise twice per tile.  They
// run full fp32 FMAs from shared memory (no TF32), as the JAX kernels'
// Precision.HIGHEST for fp32 inputs asks.  In both designs:
//  - masking: causal (key > query), the ragged tail of keys (>= sk) and of
//    queries (>= sq: padded rows, whose lse is meaningless, are kept out of
//    dK/dV as in the TPU backward); masked probabilities are exactly zero
//    and the forward fills masked scores with the finite -1e30.
//  - segment ids (SEGS, the Pallas bodies' has_segs): the same predicate in
//    all three kernels also asks q_ids[i] == kv_ids[j], with each tile's
//    ids staged beside it in shared memory.  A query row that sees no key
//    (fmha's padding, id -1 against key padding -2) ends with l = 0, so its
//    output is 0 and its lse about -1e30, as in the Pallas bodies; the
//    backward's predicate then keeps p = 0 for that row instead of
//    exp(s - lse), so no garbage reaches dK/dV or dQ.  The causal tile
//    skips stay as they are; no tile is skipped on its ids (the JAX kernels
//    run every segment block masked, apex_tpu/ops/attention.py:364-377).
//  - dropout (DROP, the Pallas bodies' has_dropout; attention_tiles.cuh's
//    hash): the forward sums l over the undropped p and multiplies the
//    kept p by 1 / (1 - rate) only where it enters P . V
//    (attention_short.py:190-196); the dK/dV kernel replays the mask on p
//    for dV and on dp before dz = p * (dp - delta), the dQ kernel on dp
//    (attention_short.py:268-276).  The hash's bh is the block's
//    blockIdx.y (blockIdx.x in the bf16 forward) and its positions the
//    absolute q0 + row and k0 + column, so the mask does not depend on the
//    tiles.  DROP and SEGS combine
//    (contrib attention needs both).
//  - bias (BIAS, the Pallas bodies' has_bias; attention_tiles.cuh's Bias,
//    read into registers before each tile's products): the forward adds it
//    to s * scale before the predicate, and the dK/dV and dQ kernels add
//    the same value the same way before p = exp(s - lse)
//    (attention_short.py:179-184,
//    :257-260; attention_mid.py:251-253, :369-371).  A row the bias alone
//    masks (-1e30 everywhere) keeps its predicate true, so its output is
//    the uniform mean of V, as JAX's softmax gives; only the predicate
//    zeroes p.
//  - dBias (DBIAS, the Pallas bodies' dbias output under bias_grad,
//    attention_short.py:281-294, attention_mid.py:326-342, :403-410): an
//    instance of the dQ kernel only, and only beside BIAS, that also
//    stores each pair's dz = p * (dp - delta) unscaled in fp32 to a (bh,
//    sq, sk) output (attention_tiles.cuh's store_dbias), before dz is
//    scaled and rounded for dQ.  delta already holds the lse cotangent, so
//    the mid rung's dz = p * (dp - delta + dlse) needs no new term.  The
//    causal tile skip stays (JAX runs every block once dBias is emitted):
//    the wrapper zero-fills the output, and a skipped pair's dz is 0.  The
//    wrappers sum it over the bias's broadcast dims outside the kernel, as
//    JAX sums it in XLA (attention_short.py:495-504).
//
// What bounds them on the card: at the flagship's training shape (b*h = 64,
// s = 1024, d = 128, causal, bf16) the forward does 2 * 2 * d * s(s+1)/2
// flops per (b*h) over 4 * s * d * 2 bytes, ~256 flop/byte, near the
// H100's ~295 flop/byte bf16 balance point; the backward does 2.5x the
// flops over 2x the bytes and is bound by operations.  The bf16 designs
// are in attention_fwd_sm90.cuh and attention_bwd_sm90.cuh.

// The element types, one a library: a source built with ATTN_F16 defined
// (attention_*_f16.cu) holds the fp16 instances only (dtype 2), one with
// ATTN_F32 (attention_*_f32.cu) the fp32 ones (0), and the plain source
// the bf16 ones (1).  The build runs one nvcc a source, all at once, so
// its wall is about that of the heaviest third.

#pragma once

#include "attention_bwd_sm90.cuh"
#include "attention_fwd_sm90.cuh"
#include "attention_tiles.cuh"

// Consumer warpgroups of the bf16 forward (64 query rows each): the mid
// rung's 2; attention_short.cu may set its own before the include.
#ifndef ATTN_FWD_WARPGROUPS
#define ATTN_FWD_WARPGROUPS 2
#endif

// Consumer warpgroups of the bf16 backward's two kernels (64 keys of a
// dK/dV block or 64 query rows of a dQ block each).
#ifndef ATTN_BWD_WARPGROUPS
#define ATTN_BWD_WARPGROUPS 2
#endif

namespace attn {
namespace {

// ------------------------------------------------------------------ forward

// Shared-memory layout of an fp32 forward block, in bytes (K rows padded by
// one float: 32 lanes read 32 rows at one column).
template <int D>
struct FwdLayout {
  static constexpr int LDQ = D;
  static constexpr int LDK = D + 1;
  static constexpr int LDV = D;
  static constexpr int LDS = kTile;   // scores, then probabilities
  static constexpr int LDO = D;       // accumulator
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = round_up(Q_OFF + kTile * LDQ * 4, 128);
  static constexpr int V_OFF = round_up(K_OFF + kTile * LDK * 4, 128);
  static constexpr int S_OFF = round_up(V_OFF + kTile * LDV * 4, 128);
  static constexpr int O_OFF = round_up(S_OFF + kTile * LDS * 4, 128);
  static constexpr int BYTES = round_up(O_OFF + kTile * LDO * 4, 128);
};

// The fp32 forward (bf16 runs sm90::fwd_kernel, attention_fwd_sm90.cuh).
// q, out: (bh, sq, D); k, v: (bh, sk, D); lse: (bh, sq) fp32; with SEGS,
// q_ids (bh / heads, sq) and kv_ids (bh / heads, sk) int32.
template <int D, bool SEGS, bool DROP, bool BIAS>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ q_ids,
                const int* __restrict__ kv_ids, float* __restrict__ out,
                float* __restrict__ lse, int heads, int sq, int sk,
                int causal, float scale, Dropout dr, Bias bias) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* Ks = reinterpret_cast<float*>(smem + L::K_OFF);
  float* Vs = reinterpret_cast<float*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  // the block's query ids and the current key tile's, after the layout
  int* qid = reinterpret_cast<int*>(smem + L::BYTES);
  int* kid = reinterpret_cast<int*>(smem + L::BYTES + id_bytes<SEGS>(kTile));

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRows;
  const long bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const long brow = SEGS ? bh / heads : 0;
  const unsigned hrow = DROP ? drop_row(dr, bh) : 0u;
  const float* bslab = BIAS ? bias_slab(bias, bh, heads) : nullptr;

  load_tile<float, D>(Qs, L::LDQ, q + bh * sq * D, q0, kTile, sq);
  if constexpr (SEGS) load_ids(qid, q_ids + brow * sq, q0, kTile, sq);
  zero_f(Os, L::LDO, kTile, D);
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();   // the previous tile's products are done with K/V
    load_tiles<float, D>(Ks, L::LDK, Vs, L::LDV, kb, vb, k0, kTile, sk);
    if constexpr (SEGS) load_ids(kid, kv_ids + brow * sk, k0, kTile, sk);
    __syncthreads();

    [[maybe_unused]] float bv[kRows][2];
    if constexpr (BIAS) load_bias<2, false>(bv, bslab, sq, sk, q0 + row0, k0, lane);
    abT_fp32<kTile, D>(Qs + row0 * L::LDQ, L::LDQ, Ks, L::LDK,
                       Ss + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

    // online softmax over this warp's rows; lane owns columns lane and
    // lane + 32 of the tile
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const int qi = q0 + row;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kj = k0 + lane + 32 * h;
        ok[h] = kj < sk && (!causal || kj <= qi) &&
                (!SEGS || qid[row] == kid[lane + 32 * h]);
        s[h] = ok[h] ? biased<BIAS>(Ss[row * L::LDS + lane + 32 * h] * scale,
                                    bv[r][h])
                     : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[0], s[1])));
      float p[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) p[h] = ok[h] ? expf(s[h] - m_new) : 0.0f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[0] + p[1]);
      m[r] = m_new;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // l has the undropped p; only what enters P . V is dropped
        float pv = p[h];
        if constexpr (DROP) {
          pv = drop_keep(dr, hrow, qi, k0 + lane + 32 * h) ? pv * dr.inv_keep
                                                           : 0.0f;
        }
        Ss[row * L::LDS + lane + 32 * h] = pv;
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) Os[row * L::LDO + lane + 32 * i] *= corr;
    }
    __syncwarp();

    ab_fp32<kTile, D>(Ss + row0 * L::LDS, L::LDS, Vs, L::LDV,
                      Os + row0 * L::LDO, L::LDO, lane);
    __syncwarp();
  }

  // normalise and store this warp's rows
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    if (qi >= sq) continue;
    const float ll = fmaxf(l[r], 1e-30f);
    const float inv = 1.0f / ll;
    float* o = out + (bh * sq + qi) * D;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      o[lane + 32 * i] = Os[row * L::LDO + lane + 32 * i] * inv;
    }
    if (lane == 0) lse[bh * sq + qi] = m[r] + logf(ll);
  }
}

// ----------------------------------------------------------------- backward

// delta[row] = sum_c dO[row, c] * O[row, c] - dlse[row] (dlse may be null).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                  const float* __restrict__ dlse, float* __restrict__ delta,
                  long rows) {
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const long at = row * D + lane + 32 * i;
    acc = fmaf(to_f(dout[at]), to_f(out[at]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc - (dlse != nullptr ? dlse[row] : 0.0f);
}

// dK/dV block (fp32; bf16 runs sm90::bwd_dkv_kernel): 64 keys x D; query
// tiles of 32 rows, so that the block fits 227 KB.  K and V are the left
// operands (broadcast reads), Q and dO the right ones (odd leading dim);
// the (key, query) score tiles are fp32.
template <int D>
struct DkvLayout {
  static constexpr int QT = 32;
  static constexpr int LDK = D;
  static constexpr int LDQ = D + 1;
  static constexpr int LDS = QT;
  static constexpr int LDA = D;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = round_up(K_OFF + kTile * LDK * 4, 128);
  static constexpr int Q_OFF = round_up(V_OFF + kTile * LDK * 4, 128);
  static constexpr int DO_OFF = round_up(Q_OFF + QT * LDQ * 4, 128);
  static constexpr int S_OFF = round_up(DO_OFF + QT * LDQ * 4, 128);
  static constexpr int DP_OFF = round_up(S_OFF + kTile * LDS * 4, 128);
  static constexpr int DK_OFF = round_up(DP_OFF + kTile * LDS * 4, 128);
  static constexpr int DV_OFF = round_up(DK_OFF + kTile * LDA * 4, 128);
  static constexpr int LSE_OFF = round_up(DV_OFF + kTile * LDA * 4, 128);
  static constexpr int DL_OFF = LSE_OFF + QT * 4;
  static constexpr int BYTES = round_up(DL_OFF + QT * 4, 128);
};

template <int D, bool SEGS, bool DROP, bool BIAS>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ q_ids,
                    const int* __restrict__ kv_ids,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int heads, int sq, int sk,
                    int causal, float scale, Dropout dr, Bias bias) {
  using L = DkvLayout<D>;
  constexpr int QT = L::QT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + L::K_OFF);
  float* Vs = reinterpret_cast<float*>(smem + L::V_OFF);
  float* Qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* dOs = reinterpret_cast<float*>(smem + L::DO_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  float* dKs = reinterpret_cast<float*>(smem + L::DK_OFF);
  float* dVs = reinterpret_cast<float*>(smem + L::DV_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* dl_s = reinterpret_cast<float*>(smem + L::DL_OFF);
  // the block's key ids and the current query tile's, after the layout
  int* kid = reinterpret_cast<int*>(smem + L::BYTES);
  int* qid = reinterpret_cast<int*>(smem + L::BYTES + id_bytes<SEGS>(kTile));

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRows;
  const long bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const float* qb = q + bh * sq * D;
  const float* dob = dout + bh * sq * D;
  const long brow = SEGS ? bh / heads : 0;
  const unsigned hrow = DROP ? drop_row(dr, bh) : 0u;
  const float* bslab = BIAS ? bias_slab(bias, bh, heads) : nullptr;

  load_tiles<float, D>(Ks, L::LDK, Vs, L::LDK, k + bh * sk * D,
                       v + bh * sk * D, k0, kTile, sk);
  if constexpr (SEGS) load_ids(kid, kv_ids + brow * sk, k0, kTile, sk);
  zero_f(dKs, L::LDA, kTile, D);
  zero_f(dVs, L::LDA, kTile, D);

  // causal: query tiles wholly above this key tile see none of its keys
  const int q_begin = causal ? (k0 / QT) * QT : 0;
  for (int q0 = q_begin; q0 < sq; q0 += QT) {
    __syncthreads();   // the previous tile's products are done with Q/dO
    load_tiles<float, D>(Qs, L::LDQ, dOs, L::LDQ, qb, dob, q0, QT, sq);
    if constexpr (SEGS) load_ids(qid, q_ids + brow * sq, q0, QT, sq);
    for (int i = threadIdx.x; i < QT; i += kThreads) {
      const bool in = q0 + i < sq;
      lse_s[i] = in ? lse[bh * sq + q0 + i] : 0.0f;
      dl_s[i] = in ? delta[bh * sq + q0 + i] : 0.0f;
    }
    __syncthreads();

    [[maybe_unused]] float bv[kRows][QT / 32];
    if constexpr (BIAS) {
      load_bias<QT / 32, true>(bv, bslab, sq, sk, k0 + row0, q0, lane);
    }
    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    abT_fp32<QT, D>(Ks + row0 * L::LDK, L::LDK, Qs, L::LDQ,
                    Ss + row0 * L::LDS, L::LDS, lane);
    abT_fp32<QT, D>(Vs + row0 * L::LDK, L::LDK, dOs, L::LDQ,
                    dPs + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

    // p = exp(s * scale (+ bias) - lse), dz = p * (dp - delta); lane owns
    // the query columns lane + 32 * j (the bias of key kj read down a
    // column, one query row a lane).  With dropout, dV takes the dropped p
    // and dz the dropped dp.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const int kj = k0 + row;
#pragma unroll
      for (int j = 0; j < QT / 32; ++j) {
        const int c = lane + 32 * j;
        const int qi = q0 + c;
        const bool ok = kj < sk && qi < sq && (!causal || kj <= qi) &&
                        (!SEGS || kid[row] == qid[c]);
        const float p =
            ok ? expf(biased<BIAS>(Ss[row * L::LDS + c] * scale, bv[r][j]) -
                      lse_s[c])
               : 0.0f;
        float dp = dPs[row * L::LDS + c];
        float pv = p;
        if constexpr (DROP) {
          const bool kept = drop_keep(dr, hrow, qi, kj);
          pv = kept ? p * dr.inv_keep : 0.0f;
          dp = kept ? dp * dr.inv_keep : 0.0f;
        }
        const float dz = p * (dp - dl_s[c]);
        Ss[row * L::LDS + c] = pv;
        dPs[row * L::LDS + c] = dz * scale;
      }
    }
    __syncwarp();

    // dV += P^T dO and dK += (dz * scale)^T Q for this warp's 16 keys
    ab_fp32<QT, D>(Ss + row0 * L::LDS, L::LDS, dOs, L::LDQ,
                   dVs + row0 * L::LDA, L::LDA, lane);
    ab_fp32<QT, D>(dPs + row0 * L::LDS, L::LDS, Qs, L::LDQ,
                   dKs + row0 * L::LDA, L::LDA, lane);
    __syncwarp();
  }
  // a block with no query tile (causal, keys at or past sq) has run no
  // barrier since its accumulators were zeroed, each row by other threads
  __syncthreads();

  // store this warp's rows
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    const int kj = k0 + row;
    if (kj >= sk) continue;
    const long at = (bh * sk + kj) * D;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      dk[at + c] = dKs[row * L::LDA + c];
      dv[at + c] = dVs[row * L::LDA + c];
    }
  }
}

// dQ block (fp32; bf16 runs sm90::bwd_dq_kernel): 64 query rows x D; key
// tiles of 64.  Q and dO are the left operands, K and V the right ones
// (odd leading dim).
template <int D>
struct DqLayout {
  static constexpr int LDQ = D;
  static constexpr int LDK = D + 1;
  static constexpr int LDS = kTile;
  static constexpr int LDA = D;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = round_up(Q_OFF + kTile * LDQ * 4, 128);
  static constexpr int K_OFF = round_up(DO_OFF + kTile * LDQ * 4, 128);
  static constexpr int V_OFF = round_up(K_OFF + kTile * LDK * 4, 128);
  static constexpr int S_OFF = round_up(V_OFF + kTile * LDK * 4, 128);
  static constexpr int DP_OFF = round_up(S_OFF + kTile * LDS * 4, 128);
  static constexpr int DQ_OFF = round_up(DP_OFF + kTile * LDS * 4, 128);
  static constexpr int LSE_OFF = round_up(DQ_OFF + kTile * LDA * 4, 128);
  static constexpr int DL_OFF = LSE_OFF + kTile * 4;
  static constexpr int BYTES = round_up(DL_OFF + kTile * 4, 128);
};

// With DBIAS (only beside BIAS) dbias is the (bh, sq, sk) fp32 gradient of
// the biased scores, zero-filled by the caller.
template <int D, bool SEGS, bool DROP, bool BIAS, bool DBIAS>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ q_ids,
                   const int* __restrict__ kv_ids,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   float* __restrict__ dbias, int heads, int sq, int sk,
                   int causal, float scale, Dropout dr, Bias bias) {
  static_assert(BIAS || !DBIAS, "dBias needs a bias");
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* dOs = reinterpret_cast<float*>(smem + L::DO_OFF);
  float* Ks = reinterpret_cast<float*>(smem + L::K_OFF);
  float* Vs = reinterpret_cast<float*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  float* dQs = reinterpret_cast<float*>(smem + L::DQ_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* dl_s = reinterpret_cast<float*>(smem + L::DL_OFF);
  // the block's query ids and the current key tile's, after the layout
  int* qid = reinterpret_cast<int*>(smem + L::BYTES);
  int* kid = reinterpret_cast<int*>(smem + L::BYTES + id_bytes<SEGS>(kTile));

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRows;
  const long bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const long brow = SEGS ? bh / heads : 0;
  const unsigned hrow = DROP ? drop_row(dr, bh) : 0u;
  const float* bslab = BIAS ? bias_slab(bias, bh, heads) : nullptr;

  load_tiles<float, D>(Qs, L::LDQ, dOs, L::LDQ, q + bh * sq * D,
                       dout + bh * sq * D, q0, kTile, sq);
  if constexpr (SEGS) load_ids(qid, q_ids + brow * sq, q0, kTile, sq);
  zero_f(dQs, L::LDA, kTile, D);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lse[bh * sq + q0 + i] : 0.0f;
    dl_s[i] = in ? delta[bh * sq + q0 + i] : 0.0f;
  }

  const int kv_end = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_tiles<float, D>(Ks, L::LDK, Vs, L::LDK, kb, vb, k0, kTile, sk);
    if constexpr (SEGS) load_ids(kid, kv_ids + brow * sk, k0, kTile, sk);
    __syncthreads();

    [[maybe_unused]] float bv[kRows][2];
    if constexpr (BIAS) load_bias<2, false>(bv, bslab, sq, sk, q0 + row0, k0, lane);
    // S = Q K^T and dP = dO V^T for this warp's 16 query rows
    abT_fp32<kTile, D>(Qs + row0 * L::LDQ, L::LDQ, Ks, L::LDK,
                       Ss + row0 * L::LDS, L::LDS, lane);
    abT_fp32<kTile, D>(dOs + row0 * L::LDQ, L::LDQ, Vs, L::LDK,
                       dPs + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const int qi = q0 + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const int kj = k0 + c;
        const bool ok = kj < sk && qi < sq && (!causal || kj <= qi) &&
                        (!SEGS || qid[row] == kid[c]);
        const float p =
            ok ? expf(biased<BIAS>(Ss[row * L::LDS + c] * scale, bv[r][h]) -
                      lse_s[row])
               : 0.0f;
        float dp = dPs[row * L::LDS + c];
        if constexpr (DROP) {
          dp = drop_keep(dr, hrow, qi, kj) ? dp * dr.inv_keep : 0.0f;
        }
        const float dz = p * (dp - dl_s[row]);
        store_dbias<DBIAS>(dbias, bh, sq, sk, qi, kj, dz);
        Ss[row * L::LDS + c] = dz * scale;
      }
    }
    __syncwarp();

    // dQ += (dz * scale) K
    ab_fp32<kTile, D>(Ss + row0 * L::LDS, L::LDS, Ks, L::LDK,
                      dQs + row0 * L::LDA, L::LDA, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    if (qi >= sq) continue;
    const long at = (bh * sq + qi) * D;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      dq[at + lane + 32 * i] = dQs[row * L::LDA + lane + 32 * i];
    }
  }
}

// ------------------------------------------------------------------ launch

// bf16/fp16: the Hopper forward of attention_fwd_sm90.cuh, with ATTN_FWD_WARPGROUPS
// consumer warpgroups (64 query rows each) and the short/mid rounding order
// ((q . k) * scale); fp32: attn_fwd_kernel.
template <typename T, int D, bool SEGS, bool DROP, bool BIAS>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* q_ids, const int* kv_ids, void* out,
                       float* lse, int bh, int heads, int sq, int sk,
                       int causal, float scale, Dropout dr, Bias bias,
                       cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return sm90::launch<D, ATTN_FWD_WARPGROUPS, SEGS, DROP, BIAS, false, T>(
        q, k, v, q_ids, kv_ids, out, lse, bh, heads, sq, sk, causal, scale,
        dr, bias, stream);
  } else {
    using L = FwdLayout<D>;
    constexpr int kBytes = L::BYTES + 2 * id_bytes<SEGS>(kTile);
    static bool opted = false;
    cudaError_t err =
        opt_in(attn_fwd_kernel<D, SEGS, DROP, BIAS>, kBytes, &opted);
    if (err != cudaSuccess) return err;
    dim3 grid((sq + kTile - 1) / kTile, bh);
    attn_fwd_kernel<D, SEGS, DROP, BIAS><<<grid, kThreads, kBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), q_ids, kv_ids, static_cast<float*>(out),
        lse, heads, sq, sk, causal, scale, dr, bias);
    return cudaGetLastError();
  }
}

// The delta pass, then bf16/fp16: the dK/dV and dQ kernels of
// attention_bwd_sm90.cuh with ATTN_BWD_WARPGROUPS consumer warpgroups (64
// keys or query rows each); fp32: attn_bwd_dkv_kernel, attn_bwd_dq_kernel.
template <typename T, int D, bool SEGS, bool DROP, bool BIAS, bool DBIAS>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const int* q_ids, const int* kv_ids, const void* out,
                       const void* dout, const float* lse, const float* dlse,
                       float* delta, void* dq, void* dk, void* dv,
                       float* dbias, int bh, int heads, int sq, int sk,
                       int causal, float scale, Dropout dr, Bias bias,
                       cudaStream_t stream) {
  const long rows = (long)bh * sq;
  attn_delta_kernel<T, D><<<(unsigned)((rows + kWarps - 1) / kWarps),
                            kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), dlse, delta,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 2) {
    return sm90::launch_bwd<D, ATTN_BWD_WARPGROUPS, SEGS, DROP, BIAS, DBIAS,
                            T>(
        q, k, v, dout, q_ids, kv_ids, lse, delta, dq, dk, dv, dbias, bh,
        heads, sq, sk, causal, scale, dr, bias, stream);
  } else {
    using KV = DkvLayout<D>;
    using QL = DqLayout<D>;
    constexpr int kKvBytes =
        KV::BYTES + id_bytes<SEGS>(kTile) + id_bytes<SEGS>(KV::QT);
    constexpr int kQBytes = QL::BYTES + 2 * id_bytes<SEGS>(kTile);
    static bool opted_kv = false, opted_q = false;
    err = opt_in(attn_bwd_dkv_kernel<D, SEGS, DROP, BIAS>, kKvBytes,
                 &opted_kv);
    if (err != cudaSuccess) return err;
    err = opt_in(attn_bwd_dq_kernel<D, SEGS, DROP, BIAS, DBIAS>, kQBytes,
                 &opted_q);
    if (err != cudaSuccess) return err;
    const float* qt = static_cast<const float*>(q);
    const float* kt = static_cast<const float*>(k);
    const float* vt = static_cast<const float*>(v);
    const float* dot = static_cast<const float*>(dout);
    attn_bwd_dkv_kernel<D, SEGS, DROP, BIAS>
        <<<dim3((sk + kTile - 1) / kTile, bh), kThreads, kKvBytes, stream>>>(
            qt, kt, vt, q_ids, kv_ids, dot, lse, delta,
            static_cast<float*>(dk), static_cast<float*>(dv), heads, sq, sk,
            causal, scale, dr, bias);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_dq_kernel<D, SEGS, DROP, BIAS, DBIAS>
        <<<dim3((sq + kTile - 1) / kTile, bh), kThreads, kQBytes, stream>>>(
            qt, kt, vt, q_ids, kv_ids, dot, lse, delta,
            static_cast<float*>(dq), dbias, heads, sq, sk, causal, scale, dr,
            bias);
    return cudaGetLastError();
  }
}

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, each taken by its own build (ATTN_F32,
// the plain source, ATTN_F16); head dims 64 and 128.  q_ids/kv_ids: both
// null (no segment ids) or (bh / heads, sq) and (bh / heads, sk) int32.
// dr.inv_keep == 0: no dropout.  bias.ptr null: no bias; dbias null (the
// backward): no dBias.  Each (dtype, d) has eight instances, with and
// without SEGS, DROP and BIAS, and the backward's dQ kernel four more,
// the BIAS ones with DBIAS.
#define ATTN_BIAS(CALL, T, D, SEGS, DROP)                             \
  (biased ? (emit ? CALL(T, D, SEGS, DROP, true, true)                \
                  : CALL(T, D, SEGS, DROP, true, false))              \
          : CALL(T, D, SEGS, DROP, false, false))
#define ATTN_DISPATCH_TD(CALL, T, D)                                  \
  if (segs) {                                                         \
    if (drop) return ATTN_BIAS(CALL, T, D, true, true);               \
    return ATTN_BIAS(CALL, T, D, true, false);                        \
  }                                                                   \
  if (drop) return ATTN_BIAS(CALL, T, D, false, true);                \
  return ATTN_BIAS(CALL, T, D, false, false)
#if defined(ATTN_F16)
#define ATTN_DTYPE 2
#define ATTN_T f16
#elif defined(ATTN_F32)
#define ATTN_DTYPE 0
#define ATTN_T float
#else
#define ATTN_DTYPE 1
#define ATTN_T bf16
#endif
#define ATTN_DISPATCH(CALL)                                              \
  if (dtype == ATTN_DTYPE && d == 128) { ATTN_DISPATCH_TD(CALL, ATTN_T, 128); } \
  if (dtype == ATTN_DTYPE && d == 64) { ATTN_DISPATCH_TD(CALL, ATTN_T, 64); }   \
  return cudaErrorInvalidValue

inline cudaError_t fwd(const void* q, const void* k, const void* v,
                       const int* q_ids, const int* kv_ids, void* out,
                       float* lse, int bh, int heads, int sq, int sk, int d,
                       int dtype, int causal, float scale, Dropout dr,
                       Bias bias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  if (bad_ids(q_ids, kv_ids, bh, heads)) return cudaErrorInvalidValue;
  if (bad_bias(bias.ptr, bias.stride_b, bias.stride_h, bh, heads))
    return cudaErrorInvalidValue;
  const bool segs = q_ids != nullptr;
  const bool drop = dr.inv_keep != 0.0f;
  const bool biased = bias.ptr != nullptr;
  constexpr bool emit = false;   // the forward has no dBias
#define CALL(T, D, SEGS, DROP, BIAS, DBIAS)                                 \
  launch_fwd<T, D, SEGS, DROP, BIAS>(q, k, v, q_ids, kv_ids, out, lse, bh, heads, \
                               sq, sk, causal, scale, dr, bias, s)
  ATTN_DISPATCH(CALL);
#undef CALL
}

// dbias: null, or (bh, sq, sk) fp32, zero-filled, for the dQ kernel's
// DBIAS instance (only with a bias).
inline cudaError_t bwd(const void* q, const void* k, const void* v,
                       const int* q_ids, const int* kv_ids, const void* out,
                       const void* dout, const float* lse, const float* dlse,
                       float* delta, void* dq, void* dk, void* dv,
                       float* dbias, int bh, int heads, int sq, int sk, int d,
                       int dtype, int causal, float scale, Dropout dr,
                       Bias bias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  if (bad_ids(q_ids, kv_ids, bh, heads)) return cudaErrorInvalidValue;
  if (bad_bias(bias.ptr, bias.stride_b, bias.stride_h, bh, heads, dbias))
    return cudaErrorInvalidValue;
  const bool segs = q_ids != nullptr;
  const bool drop = dr.inv_keep != 0.0f;
  const bool biased = bias.ptr != nullptr;
  const bool emit = dbias != nullptr;
#define CALL(T, D, SEGS, DROP, BIAS, DBIAS)                               \
  launch_bwd<T, D, SEGS, DROP, BIAS, DBIAS>(q, k, v, q_ids, kv_ids, out, dout, \
                               lse, dlse, delta, dq, dk, dv, dbias, bh,  \
                               heads, sq, sk, causal, scale, dr, bias, s)
  ATTN_DISPATCH(CALL);
#undef CALL
}

#undef ATTN_DISPATCH
#undef ATTN_DISPATCH_TD
#undef ATTN_BIAS

}  // namespace
}  // namespace attn
