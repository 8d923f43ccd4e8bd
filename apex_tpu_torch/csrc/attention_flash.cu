// Flash attention (the ladder's rung above FMHA_MID_MAX_SEQ) for Hopper
// (sm_90a): a streamed forward and the FA2-split backward, dK/dV and dQ.
//
// Replaces, in apex_tpu/ops/attention.py:
//   _fa_fwd_kernel     (:213, call :396) -> flash_fwd
//   _fa_bwd_dkv_kernel (:429, call :673) -> flash_bwd_dkv
//   _fa_bwd_dq_kernel  (:534, call :722) -> flash_bwd_dq
// over the flattened (b*h, s, d) layout of the JAX _flash custom_vjp.  The
// TPU kernels walk a (b*h, q block, k block) grid whose last axis runs in
// order and carries m/l/acc (or dK/dV, dQ) in VMEM scratch, and the Pallas
// pipeline fetches the next K/V block while the current one computes.
// Here a block owns one (b*h, query tile) (or key tile) and loops over the
// streamed operand itself, with the next tiles' copies in flight.  For bf16
// inputs all three entries run the Hopper kernels (TMA loads issued by a
// producer warpgroup through a ring of stages completed on mbarriers,
// consumer warpgroups running wgmma with the scores and the accumulators
// in registers): the forward attention_fwd_sm90.cuh's fwd_kernel, the
// backward attention_bwd_sm90.cuh's bwd_dkv_kernel and bwd_dq_kernel, the
// kernels of the short and mid rungs' backward, launched one per entry.
// The fp32 instances keep SIMT kernels here (wgmma has no fp32 form, and
// TF32 would break the fp32 parity Precision.HIGHEST asks for), which copy
// with cp.async into a second shared-memory buffer issued before the
// current tile's products (two buffers, one commit group per tile).  That
// overlap is what the rung exists for: at s = 4096 a block streams up to
// 64 tiles.
//
// Function, as the TPU kernels compute it:
//  - forward: q is scaled BEFORE the product (:242) -- the kernels scale
//    the Q tile in fp32 once it lands and, for bf16, round it to bf16 as
//    the tensor-core operand (as the TPU's default precision rounds the
//    fp32 operand of its MXU; attention_fwd_sm90.cuh's QSCALE); masked
//    scores are the finite -1e30, masked probabilities exactly 0, l is
//    clamped at 1e-30, lse = m + log(l).
//  - backward: scores are replayed from lse with the scale AFTER the
//    product, s = (q . k) * scale (:464, :580); delta = rowsum(dO * O) is
//    computed outside the kernels (as JAX computes it in XLA, :647-650);
//    dz = p * (dp - delta); dV += p^T dO, dK += (dz * scale)^T Q,
//    dQ += (dz * scale) K, with p and dz * scale rounded to bf16 as the
//    products' operands for bf16.  There is no lse cotangent on this rung,
//    so this is exactly the short/mid backward's function
//    (_flash_bwd_plain computes what _short_bwd_plain does) and the bf16
//    entries pass the caller's delta straight to sm90::launch_dkv and
//    sm90::launch_dq, each with the other entry's outputs null.
//  - masking: causal is top-left aligned (key <= query by index), sq != sk
//    is allowed, keys at or past sk are masked, and the dK/dV kernels also
//    mask query rows at or past sq (their lse and delta are meaningless
//    and would pollute the sums, :513-520).  Rows past an operand's end
//    are zero-filled by the copy (TMA's out-of-bounds fill, or cp.async
//    with a source size of 0), so no garbage can reach a sum through 0 *
//    NaN.
//  - segment ids (SEGS, the Pallas bodies' has_segs): the predicate of all
//    three kernels also asks q_ids[i] == kv_ids[j], the ids (bh / heads, s)
//    int32 of attention_tiles.cuh.  A query row that sees no key has l = 0:
//    out 0 and lse about -1e30, and the backward's predicate keeps its p at
//    0 (never exp(s - lse)).  The causal tile skips stay; none is taken on
//    the ids.  The wrappers count these launches as flash_fwd_seg,
//    flash_bwd_dkv_seg and flash_bwd_dq_seg.
//  - dropout (DROP, the Pallas bodies' has_dropout; the hash of
//    attention_tiles.cuh over the global bh and the absolute positions):
//    the forward keeps l and the lse undropped and drops and scales only
//    the p that enters P . V (:276-281); the dK/dV kernel replays the mask
//    on p for dV and on dp before dz (:491-498), the dQ kernel on dp
//    (:605-611).  Counted as flash_fwd_drop, flash_bwd_dkv_drop and
//    flash_bwd_dq_drop (_seg_drop beside ids).
//  - bias (BIAS, the Pallas bodies' has_bias, :250-251, :465-466,
//    :581-582; the Bias operand of attention_tiles.cuh): the forward adds
//    it to its already scaled score, the backward kernels to (q . k) *
//    scale, before the predicate.  Counted with _bias appended
//    (flash_fwd_bias, ...).
//  - dBias (DBIAS, the dQ kernel's dbias output under bias_grad, :545-567,
//    :612-630, out spec :704-713): an instance of the dQ kernel only, and
//    only beside BIAS, that also stores each pair's dz = p * (dp - delta)
//    unscaled in fp32 to a (bh, sq, sk) output, before dz is scaled and
//    rounded for dQ.  The causal tile skip stays (JAX runs every block once
//    dBias is emitted, :563-567): the wrapper zero-fills the output, and a
//    skipped pair's dz is 0.  The wrapper sums it over the bias's
//    broadcast dims, as JAX does in XLA (:767-783).  It adds 4 bytes a pair
//    of writes (1.07 GB at b*h = 16, s = 4096) to a kernel bound by
//    operations.  Counted as flash_bwd_dq_dbias (_seg, _drop before it).
//
// Tiles, chosen for s >= 4096 (at b*h = 16, the Llama-mode training shape):
//  - forward: in bf16 128-row query tiles (two consumer warpgroups of 64
//    rows) and 128-key tiles in two stages (attention_fwd_sm90.cuh: 160 KB
//    of shared memory at D = 128, one block per SM; 32 x 16 = 512 blocks
//    at s = 4096, heaviest causal tiles first); in fp32 64-row tiles (4
//    warps) and 64-key tiles, double-buffered.
//  - bf16 backward: attention_bwd_sm90.cuh's blocks of 64 * NC keys (dK/dV)
//    or query rows (dQ), streaming 64-row query tiles from the causal
//    diagonal down or 64-key tiles up to it through a ring of
//    ATTN_BWD_STAGES stages, heaviest blocks first.  NC is chosen here
//    (kBwdWarpgroups), apart from the short and mid sources'
//    ATTN_BWD_WARPGROUPS; the ring keeps the header's two stages.  At the
//    Llama mode's b*h = 16, s = 4096, d = 128, causal (python -m
//    apex_tpu_torch.tools.bwd_rows; NVIDIA H100 80GB HBM3 at 700 W,
//    PERF.md) two warpgroups ran the dK/dV kernel in
//    0.2463 ms (512 blocks of 128 keys on 132 SMs, one an SM) against
//    0.2923 with one (1,024 blocks of 64 keys, two an SM), and the dQ
//    kernel in 0.1849 against 0.1884.  A third stage gave nothing: 0.2572
//    and 0.1840 ms with two warpgroups, and with one 0.4712 and 0.2647
//    (32 KB of K and V and three 32 KB stages leave room for one block an
//    SM, where two stages fit two).
//  - fp32 dK/dV: one block per (b*h, 64-key tile), streaming 32-row query
//    tiles, Q/dO/lse/delta double-buffered; fp32 dQ: one block per (b*h,
//    64-row query tile), streaming 32-key K/V tiles.  Each warp owns 16
//    rows of its block's tile end to end, with attention_tiles.cuh's full
//    fp32 FMA warp products, as Precision.HIGHEST asks.
//
// What bounds them on the card: at b*h = 16, s = 4096, d = 128, causal,
// bf16 the forward does 4 * d flops per causal (q, k) pair, 6.9e10 in all,
// over 4 * 16 * 4096 * 128 * 2 bytes = 67 MB: ~1,000 flop/byte, above the
// H100's ~295, so it is bound by operations (0.07 ms at 989 TFLOP/s); the
// dK/dV kernel does 8 * d and the dQ kernel 6 * d flops per pair over a
// few more bytes, bound by operations too (0.139 and 0.104 ms).  The bf16
// backward's kernels keep the scores, the score gradients and the
// accumulators in registers and read every operand through TMA into
// swizzled shared memory, so the products run at the tensor cores' rate
// and the elementwise work between them (the replay of p, dz, the
// variants' hash, id and bias reads) is what keeps them from the bound:
// 0.2455 and 0.1851 ms at that shape, 1.8x (PERF.md).
//
// What the long walk asked of those kernels, beside the short and mid
// rungs' (PERF.md):
//  - the ring's phases: a block wraps the two stages up to 32 times, and a
//    warpgroup whose tile lies wholly above the diagonal still waits for
//    and releases each stage.  chip_smoke.py holds every instance at a
//    causal 4098 x 4131 case (sq no multiple of 4, sk odd), the same bits
//    on a second call, and bwd_rows each block size and ring there.
//  - load balance: the dK/dV grid's first key tiles walk the most query
//    tiles and are issued first, the dQ grid's heaviest query tiles too,
//    so the last wave is the lightest; 512 blocks of two warpgroups beat
//    1,024 of one (above).
//  - two entries: flash_bwd_dkv and flash_bwd_dq each build their own
//    BwdParams with the other's outputs null and launch one kernel, so the
//    wrappers' counters count one launch each, as before.
//  - build time: the 40 bf16 backward instances of this source and its 16
//    forward ones build in about 105 s alone; ptxas spills only in the
//    d = 128 dK/dV bias instances (120-172 bytes) and the forward's bias
//    instances, as on the short and mid rungs (chip_smoke.py phase 1).

#include "attention_bwd_sm90.cuh"
#include "attention_fwd_sm90.cuh"
#include "attention_tiles.cuh"

namespace flash {
namespace {

using attn::bf16;
using attn::f16;
using attn::round_up;

constexpr int kRows = attn::kRows;   // rows of a tile each warp owns (16)
constexpr float kNegInf = attn::kNegInf;

// Consumer warpgroups of the bf16 backward's blocks: 64 keys each in the
// dK/dV kernel, 64 query rows each in the dQ kernel (two for both: the
// note).
constexpr int kBwdWarpgroups = 2;

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 4 bytes (an fp32 element: a padded row's odd leading dim breaks
// 16-byte alignment); a source size of 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [r0, r0 + ROWS) of an fp32 (n, D) matrix into shared
// memory with leading dim LD; rows at or past n are zero-filled (their
// source address is clamped to row 0 and not read).
template <int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void async_tile(float* dst, const float* src,
                                           int r0, int n) {
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const bool in = r0 + r < n;
    cp_async4(dst + r * LD + c, src + (long)(in ? r0 + r : 0) * D + c,
              in ? 4 : 0);
  }
}

// The same for ROWS consecutive fp32 values (lse, delta); past n, zeros.
template <int ROWS, int THREADS>
__device__ __forceinline__ void async_vec(float* dst, const float* src,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool in = r0 + i < n;
    cp_async4(dst + i, src + (in ? r0 + i : 0), in ? 4 : 0);
  }
}

// The same for ROWS int32 segment ids; past n, zeros (masked anyway).
template <int ROWS, int THREADS>
__device__ __forceinline__ void async_ids(int* dst, const int* src, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool in = r0 + i < n;
    cp_async4(dst + i, src + (in ? r0 + i : 0), in ? 4 : 0);
  }
}

__device__ __forceinline__ void zero_f(float* dst, int ld, int rows,
                                       int cols, int threads) {
  for (int i = threadIdx.x; i < rows * cols; i += threads) {
    dst[(i / cols) * ld + i % cols] = 0.0f;
  }
}

// ------------------------------------------------------------------ forward

// The fp32 forward (bf16 runs sm90::fwd_kernel, attention_fwd_sm90.cuh):
// 64-row query tiles (4 warps), 64-key tiles double-buffered.
template <int D>
struct FwdTiles {
  static constexpr int QT = 64;   // query rows per block
  static constexpr int KT = 64;   // keys per streamed tile
  static constexpr int kThreads = QT / kRows * 32;
  static constexpr int LDQ = D;
  static constexpr int LDK = D + 1;
  static constexpr int LDV = D;
  static constexpr int LDS = KT;   // scores, then probabilities
  static constexpr int LDO = D;    // accumulator
  static constexpr int K_BUF = round_up(KT * LDK * 4, 128);
  static constexpr int V_BUF = round_up(KT * LDV * 4, 128);
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = round_up(QT * LDQ * 4, 128);
  static constexpr int V_OFF = K_OFF + 2 * K_BUF;
  static constexpr int S_OFF = V_OFF + 2 * V_BUF;
  static constexpr int O_OFF = round_up(S_OFF + QT * LDS * 4, 128);
  static constexpr int BYTES = round_up(O_OFF + QT * LDO * 4, 128);
};

// q, out: (bh, sq, D); k, v: (bh, sk, D); lse: (bh, sq) fp32; with SEGS,
// q_ids (bh / heads, sq) and kv_ids (bh / heads, sk) int32.
template <int D, bool SEGS, bool DROP, bool BIAS>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ q_ids,
                 const int* __restrict__ kv_ids, float* __restrict__ out,
                 float* __restrict__ lse, int heads, int sq, int sk,
                 int causal, float scale, attn::Dropout dr, attn::Bias bias) {
  using L = FwdTiles<D>;
  constexpr int QT = L::QT, KT = L::KT, TH = L::kThreads;
  constexpr int KID = attn::id_bytes<SEGS>(KT);
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  auto Ks = [&](int buf) {
    return reinterpret_cast<float*>(smem + L::K_OFF + buf * L::K_BUF);
  };
  auto Vs = [&](int buf) {
    return reinterpret_cast<float*>(smem + L::V_OFF + buf * L::V_BUF);
  };
  // after the layout: the block's query ids, then two key-id buffers
  int* qid = reinterpret_cast<int*>(smem + L::BYTES);
  auto kid = [&](int buf) {
    return reinterpret_cast<int*>(smem + L::BYTES +
                                  attn::id_bytes<SEGS>(QT) + buf * KID);
  };

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRows;
  const long bh = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int* kidb = SEGS ? kv_ids + (bh / heads) * sk : nullptr;
  const unsigned hrow = DROP ? attn::drop_row(dr, bh) : 0u;
  const float* bslab =
      BIAS ? attn::bias_slab(bias, bh, heads) : nullptr;
  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + QT) : sk;
  const int n_tiles = (kv_end + KT - 1) / KT;

  async_tile<D, L::LDQ, QT, TH>(Qs, q + bh * sq * D, q0, sq);
  async_tile<D, L::LDK, KT, TH>(Ks(0), kb, 0, sk);
  async_tile<D, L::LDV, KT, TH>(Vs(0), vb, 0, sk);
  if constexpr (SEGS) {
    async_ids<QT, TH>(qid, q_ids + (bh / heads) * sq, q0, sq);
    async_ids<KT, TH>(kid(0), kidb, 0, sk);
  }
  cp_async_commit();
  zero_f(Os, L::LDO, QT, D, TH);
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KT;
    // the next tile's copy goes out before this tile's products; its
    // buffer was released by the barrier that ended the previous tile
    if (t + 1 < n_tiles) {
      async_tile<D, L::LDK, KT, TH>(Ks((t + 1) & 1), kb, k0 + KT, sk);
      async_tile<D, L::LDV, KT, TH>(Vs((t + 1) & 1), vb, k0 + KT, sk);
      if constexpr (SEGS) async_ids<KT, TH>(kid((t + 1) & 1), kidb, k0 + KT, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      // q * scale in fp32, before the product
      for (int i = threadIdx.x; i < QT * D; i += TH) {
        Qs[(i / D) * L::LDQ + i % D] *= scale;
      }
      __syncthreads();
    }
    const float* Kt = Ks(t & 1);
    const float* Vt = Vs(t & 1);
    const int* kt_ids = kid(t & 1);

    [[maybe_unused]] float bv[kRows][KT / 32];
    if constexpr (BIAS) {
      attn::load_bias<KT / 32, false>(bv, bslab, sq, sk, q0 + row0, k0, lane);
    }
    attn::abT_fp32<KT, D>(Qs + row0 * L::LDQ, L::LDQ, Kt, L::LDK,
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
                (!SEGS || qid[row] == kt_ids[lane + 32 * h]);
        s[h] = ok[h] ? attn::biased<BIAS>(Ss[row * L::LDS + lane + 32 * h],
                                          bv[r][h])
                     : kNegInf;
      }
      const float m_new = fmaxf(m[r], attn::warp_max(fmaxf(s[0], s[1])));
      float p[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) p[h] = ok[h] ? expf(s[h] - m_new) : 0.0f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + attn::warp_sum(p[0] + p[1]);
      m[r] = m_new;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // l has the undropped p; only what enters P . V is dropped
        float pv = p[h];
        if constexpr (DROP) {
          pv = attn::drop_keep(dr, hrow, qi, k0 + lane + 32 * h)
                   ? pv * dr.inv_keep
                   : 0.0f;
        }
        Ss[row * L::LDS + lane + 32 * h] = pv;
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) Os[row * L::LDO + lane + 32 * i] *= corr;
    }
    __syncwarp();

    attn::ab_fp32<KT, D>(Ss + row0 * L::LDS, L::LDS, Vt, L::LDV,
                         Os + row0 * L::LDO, L::LDO, lane);
    __syncthreads();   // every warp is done with this tile's buffers
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

// ---------------------------------------------------------------- dK / dV

// The fp32 dK/dV block (bf16 runs sm90::bwd_dkv_kernel,
// attention_bwd_sm90.cuh): 64 keys x D (K and V, the left operands), query
// tiles of 32 rows (Q and dO, the right operands, odd leading dim)
// double-buffered with their lse and delta; (key, query) score tiles.
template <int D>
struct DkvTiles {
  static constexpr int KT = 64;
  static constexpr int QT = 32;
  static constexpr int kThreads = KT / kRows * 32;
  static constexpr int LDK = D;
  static constexpr int LDQ = D + 1;
  static constexpr int LDS = QT;
  static constexpr int LDA = D;
  static constexpr int KV_BYTES = round_up(KT * LDK * 4, 128);
  static constexpr int Q_BUF = round_up(QT * LDQ * 4, 128);
  static constexpr int VEC_BUF = round_up(QT * 4, 128);
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + 2 * Q_BUF;
  static constexpr int LSE_OFF = DO_OFF + 2 * Q_BUF;
  static constexpr int DL_OFF = LSE_OFF + 2 * VEC_BUF;
  static constexpr int S_OFF = DL_OFF + 2 * VEC_BUF;
  static constexpr int DP_OFF = round_up(S_OFF + KT * LDS * 4, 128);
  static constexpr int DK_OFF = round_up(DP_OFF + KT * LDS * 4, 128);
  static constexpr int DV_OFF = round_up(DK_OFF + KT * LDA * 4, 128);
  static constexpr int BYTES = round_up(DV_OFF + KT * LDA * 4, 128);
};

template <int D, bool SEGS, bool DROP, bool BIAS>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ q_ids,
                     const int* __restrict__ kv_ids,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int sq, int sk,
                     int causal, float scale, attn::Dropout dr,
                     attn::Bias bias) {
  using L = DkvTiles<D>;
  constexpr int QT = L::QT, KT = L::KT, TH = L::kThreads;
  constexpr int QID = attn::id_bytes<SEGS>(QT);
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + L::K_OFF);
  float* Vs = reinterpret_cast<float*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  float* dKs = reinterpret_cast<float*>(smem + L::DK_OFF);
  float* dVs = reinterpret_cast<float*>(smem + L::DV_OFF);
  auto Qs = [&](int b) {
    return reinterpret_cast<float*>(smem + L::Q_OFF + b * L::Q_BUF);
  };
  auto dOs = [&](int b) {
    return reinterpret_cast<float*>(smem + L::DO_OFF + b * L::Q_BUF);
  };
  auto lse_s = [&](int b) {
    return reinterpret_cast<float*>(smem + L::LSE_OFF + b * L::VEC_BUF);
  };
  auto dl_s = [&](int b) {
    return reinterpret_cast<float*>(smem + L::DL_OFF + b * L::VEC_BUF);
  };
  // after the layout: the block's key ids, then two query-id buffers
  int* kid = reinterpret_cast<int*>(smem + L::BYTES);
  auto qid = [&](int b) {
    return reinterpret_cast<int*>(smem + L::BYTES +
                                  attn::id_bytes<SEGS>(KT) + b * QID);
  };

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRows;
  const long bh = blockIdx.y;
  const int k0 = blockIdx.x * KT;
  const float* qb = q + bh * sq * D;
  const float* dob = dout + bh * sq * D;
  const float* lseb = lse + bh * sq;
  const float* dlb = delta + bh * sq;
  const int* qidb = SEGS ? q_ids + (bh / heads) * sq : nullptr;
  const unsigned hrow = DROP ? attn::drop_row(dr, bh) : 0u;
  const float* bslab =
      BIAS ? attn::bias_slab(bias, bh, heads) : nullptr;

  async_tile<D, L::LDK, KT, TH>(Ks, k + bh * sk * D, k0, sk);
  async_tile<D, L::LDK, KT, TH>(Vs, v + bh * sk * D, k0, sk);
  if constexpr (SEGS) async_ids<KT, TH>(kid, kv_ids + (bh / heads) * sk, k0, sk);
  cp_async_commit();
  // causal: query tiles wholly above this key tile see none of its keys
  const int q_begin = causal ? (k0 / QT) * QT : 0;
  const int n_tiles = q_begin < sq ? (sq - q_begin + QT - 1) / QT : 0;
  auto issue = [&](int it) {
    const int q0 = q_begin + it * QT;
    const int b = it & 1;
    async_tile<D, L::LDQ, QT, TH>(Qs(b), qb, q0, sq);
    async_tile<D, L::LDQ, QT, TH>(dOs(b), dob, q0, sq);
    async_vec<QT, TH>(lse_s(b), lseb, q0, sq);
    async_vec<QT, TH>(dl_s(b), dlb, q0, sq);
    if constexpr (SEGS) async_ids<QT, TH>(qid(b), qidb, q0, sq);
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);
  zero_f(dKs, L::LDA, KT, D, TH);
  zero_f(dVs, L::LDA, KT, D, TH);

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * QT;
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = it & 1;
    const float* Qt = Qs(b);
    const float* dOt = dOs(b);
    const float* lt = lse_s(b);
    const float* dt = dl_s(b);
    const int* qt_ids = qid(b);

    [[maybe_unused]] float bv[kRows][QT / 32];
    if constexpr (BIAS) {
      attn::load_bias<QT / 32, true>(bv, bslab, sq, sk, k0 + row0, q0, lane);
    }
    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    attn::abT_fp32<QT, D>(Ks + row0 * L::LDK, L::LDK, Qt, L::LDQ,
                          Ss + row0 * L::LDS, L::LDS, lane);
    attn::abT_fp32<QT, D>(Vs + row0 * L::LDK, L::LDK, dOt, L::LDQ,
                          dPs + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

    // p = exp(s * scale - lse), dz = p * (dp - delta); lane owns the query
    // columns lane + 32 * j.  Query rows past sq are masked here: their
    // lse and delta are zero-filled, not real.  With dropout, dV takes the
    // dropped p and dz the dropped dp.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const int kj = k0 + row;
#pragma unroll
      for (int j = 0; j < QT / 32; ++j) {
        const int c = lane + 32 * j;
        const int qi = q0 + c;
        const bool ok = kj < sk && qi < sq && (!causal || kj <= qi) &&
                        (!SEGS || kid[row] == qt_ids[c]);
        const float p =
            ok ? expf(attn::biased<BIAS>(Ss[row * L::LDS + c] * scale,
                                         bv[r][j]) - lt[c])
               : 0.0f;
        float dp = dPs[row * L::LDS + c];
        float pv = p;
        if constexpr (DROP) {
          const bool kept = attn::drop_keep(dr, hrow, qi, kj);
          pv = kept ? p * dr.inv_keep : 0.0f;
          dp = kept ? dp * dr.inv_keep : 0.0f;
        }
        const float dz = p * (dp - dt[c]);
        Ss[row * L::LDS + c] = pv;
        dPs[row * L::LDS + c] = dz * scale;
      }
    }
    __syncwarp();

    // dV += P^T dO and dK += (dz * scale)^T Q for this warp's 16 keys
    attn::ab_fp32<QT, D>(Ss + row0 * L::LDS, L::LDS, dOt, L::LDQ,
                         dVs + row0 * L::LDA, L::LDA, lane);
    attn::ab_fp32<QT, D>(dPs + row0 * L::LDS, L::LDS, Qt, L::LDQ,
                         dKs + row0 * L::LDA, L::LDA, lane);
    __syncthreads();   // every warp is done with this tile's buffers
  }
  // a block with no query tile (keys past sq, causal) still has its K/V
  // copies in flight and its zeroed accumulators unsynchronised
  cp_async_wait<0>();
  __syncthreads();

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

// -------------------------------------------------------------------- dQ

// The fp32 dQ block (bf16 runs sm90::bwd_dq_kernel): 64 query rows x D (Q
// and dO, the left operands, with their lse and delta), key tiles of 32
// (K and V, the right operands, odd leading dim) double-buffered.
template <int D>
struct DqTiles {
  static constexpr int QT = 64;
  static constexpr int KT = 32;
  static constexpr int kThreads = QT / kRows * 32;
  static constexpr int LDQ = D;
  static constexpr int LDK = D + 1;
  static constexpr int LDS = KT;
  static constexpr int LDA = D;
  static constexpr int Q_BYTES = round_up(QT * LDQ * 4, 128);
  static constexpr int K_BUF = round_up(KT * LDK * 4, 128);
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int LSE_OFF = 2 * Q_BYTES;
  static constexpr int DL_OFF = LSE_OFF + round_up(QT * 4, 128);
  static constexpr int K_OFF = DL_OFF + round_up(QT * 4, 128);
  static constexpr int V_OFF = K_OFF + 2 * K_BUF;
  static constexpr int S_OFF = V_OFF + 2 * K_BUF;
  static constexpr int DP_OFF = round_up(S_OFF + QT * LDS * 4, 128);
  static constexpr int DQ_OFF = round_up(DP_OFF + QT * LDS * 4, 128);
  static constexpr int BYTES = round_up(DQ_OFF + QT * LDA * 4, 128);
};

// With DBIAS (only beside BIAS) dbias is the (bh, sq, sk) fp32 gradient of
// the biased scores, zero-filled by the caller.
template <int D, bool SEGS, bool DROP, bool BIAS, bool DBIAS>
__global__ void __launch_bounds__(DqTiles<D>::kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ q_ids,
                    const int* __restrict__ kv_ids,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    float* __restrict__ dbias, int heads, int sq, int sk,
                    int causal, float scale, attn::Dropout dr,
                    attn::Bias bias) {
  static_assert(BIAS || !DBIAS, "dBias needs a bias");
  using L = DqTiles<D>;
  constexpr int QT = L::QT, KT = L::KT, TH = L::kThreads;
  constexpr int KID = attn::id_bytes<SEGS>(KT);
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* dOs = reinterpret_cast<float*>(smem + L::DO_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* dl_s = reinterpret_cast<float*>(smem + L::DL_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  float* dQs = reinterpret_cast<float*>(smem + L::DQ_OFF);
  auto Ks = [&](int b) {
    return reinterpret_cast<float*>(smem + L::K_OFF + b * L::K_BUF);
  };
  auto Vs = [&](int b) {
    return reinterpret_cast<float*>(smem + L::V_OFF + b * L::K_BUF);
  };
  // after the layout: the block's query ids, then two key-id buffers
  int* qid = reinterpret_cast<int*>(smem + L::BYTES);
  auto kid = [&](int b) {
    return reinterpret_cast<int*>(smem + L::BYTES +
                                  attn::id_bytes<SEGS>(QT) + b * KID);
  };

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRows;
  const long bh = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  const int* kidb = SEGS ? kv_ids + (bh / heads) * sk : nullptr;
  const unsigned hrow = DROP ? attn::drop_row(dr, bh) : 0u;
  const float* bslab =
      BIAS ? attn::bias_slab(bias, bh, heads) : nullptr;
  const int kv_end = causal ? min(sk, q0 + QT) : sk;
  const int n_tiles = (kv_end + KT - 1) / KT;

  async_tile<D, L::LDQ, QT, TH>(Qs, q + bh * sq * D, q0, sq);
  async_tile<D, L::LDQ, QT, TH>(dOs, dout + bh * sq * D, q0, sq);
  async_vec<QT, TH>(lse_s, lse + bh * sq, q0, sq);
  async_vec<QT, TH>(dl_s, delta + bh * sq, q0, sq);
  async_tile<D, L::LDK, KT, TH>(Ks(0), kb, 0, sk);
  async_tile<D, L::LDK, KT, TH>(Vs(0), vb, 0, sk);
  if constexpr (SEGS) {
    async_ids<QT, TH>(qid, q_ids + (bh / heads) * sq, q0, sq);
    async_ids<KT, TH>(kid(0), kidb, 0, sk);
  }
  cp_async_commit();
  zero_f(dQs, L::LDA, QT, D, TH);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KT;
    if (t + 1 < n_tiles) {
      async_tile<D, L::LDK, KT, TH>(Ks((t + 1) & 1), kb, k0 + KT, sk);
      async_tile<D, L::LDK, KT, TH>(Vs((t + 1) & 1), vb, k0 + KT, sk);
      if constexpr (SEGS) async_ids<KT, TH>(kid((t + 1) & 1), kidb, k0 + KT, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks(t & 1);
    const float* Vt = Vs(t & 1);
    const int* kt_ids = kid(t & 1);

    [[maybe_unused]] float bv[kRows][KT / 32];
    if constexpr (BIAS) {
      attn::load_bias<KT / 32, false>(bv, bslab, sq, sk, q0 + row0, k0, lane);
    }
    // S = Q K^T and dP = dO V^T for this warp's 16 query rows
    attn::abT_fp32<KT, D>(Qs + row0 * L::LDQ, L::LDQ, Kt, L::LDK,
                          Ss + row0 * L::LDS, L::LDS, lane);
    attn::abT_fp32<KT, D>(dOs + row0 * L::LDQ, L::LDQ, Vt, L::LDK,
                          dPs + row0 * L::LDS, L::LDS, lane);
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const int qi = q0 + row;
#pragma unroll
      for (int h = 0; h < KT / 32; ++h) {
        const int c = lane + 32 * h;
        const int kj = k0 + c;
        const bool ok = kj < sk && qi < sq && (!causal || kj <= qi) &&
                        (!SEGS || qid[row] == kt_ids[c]);
        const float p =
            ok ? expf(attn::biased<BIAS>(Ss[row * L::LDS + c] * scale,
                                         bv[r][h]) - lse_s[row])
               : 0.0f;
        float dp = dPs[row * L::LDS + c];
        if constexpr (DROP) {
          dp = attn::drop_keep(dr, hrow, qi, kj) ? dp * dr.inv_keep : 0.0f;
        }
        const float dz = p * (dp - dl_s[row]);
        attn::store_dbias<DBIAS>(dbias, bh, sq, sk, qi, kj, dz);
        Ss[row * L::LDS + c] = dz * scale;
      }
    }
    __syncwarp();

    // dQ += (dz * scale) K
    attn::ab_fp32<KT, D>(Ss + row0 * L::LDS, L::LDS, Kt, L::LDK,
                         dQs + row0 * L::LDA, L::LDA, lane);
    __syncthreads();   // every warp is done with this tile's buffers
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

// bf16/fp16: the Hopper forward of attention_fwd_sm90.cuh, 128 query rows a
// block (two consumer warpgroups), q scaled and rounded before the product
// (QSCALE); fp32: flash_fwd_kernel.
template <typename T, int D, bool SEGS, bool DROP, bool BIAS>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const int* q_ids, const int* kv_ids, void* out,
                       float* lse, int bh, int heads, int sq, int sk,
                       int causal, float scale, attn::Dropout dr,
                       attn::Bias bias, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return attn::sm90::launch<D, 2, SEGS, DROP, BIAS, true, T>(
        q, k, v, q_ids, kv_ids, out, lse, bh, heads, sq, sk, causal, scale,
        dr, bias, stream);
  } else {
    using L = FwdTiles<D>;
    constexpr int kBytes = L::BYTES + attn::id_bytes<SEGS>(L::QT) +
                           2 * attn::id_bytes<SEGS>(L::KT);
    static bool opted = false;
    cudaError_t err =
        attn::opt_in(flash_fwd_kernel<D, SEGS, DROP, BIAS>, kBytes, &opted);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D, SEGS, DROP, BIAS>
        <<<dim3((sq + L::QT - 1) / L::QT, bh), L::kThreads, kBytes, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), q_ids, kv_ids,
            static_cast<float*>(out), lse, heads, sq, sk, causal, scale, dr,
            bias);
    return cudaGetLastError();
  }
}

// bf16/fp16: the dK/dV kernel of attention_bwd_sm90.cuh, kBwdWarpgroups
// consumer warpgroups (64 keys each) a block, with the caller's delta and
// no dQ; fp32: flash_bwd_dkv_kernel.
template <typename T, int D, bool SEGS, bool DROP, bool BIAS>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const int* q_ids, const int* kv_ids, const void* dout,
                       const float* lse, const float* delta, void* dk,
                       void* dv, int bh, int heads, int sq, int sk,
                       int causal, float scale, attn::Dropout dr,
                       attn::Bias bias, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    const attn::sm90::BwdParams prm{
        q_ids, kv_ids, lse, delta, nullptr, dk, dv, nullptr, heads, sq, sk,
        causal, scale, dr, bias};
    return attn::sm90::launch_dkv<D, kBwdWarpgroups, SEGS, DROP, BIAS, T>(
        q, k, v, dout, prm, bh, stream);
  } else {
    using L = DkvTiles<D>;
    constexpr int kBytes = L::BYTES + attn::id_bytes<SEGS>(L::KT) +
                           2 * attn::id_bytes<SEGS>(L::QT);
    static bool opted = false;
    cudaError_t err = attn::opt_in(flash_bwd_dkv_kernel<D, SEGS, DROP, BIAS>,
                                   kBytes, &opted);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<D, SEGS, DROP, BIAS>
        <<<dim3((sk + L::KT - 1) / L::KT, bh), L::kThreads, kBytes, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), q_ids, kv_ids,
            static_cast<const float*>(dout), lse, delta,
            static_cast<float*>(dk), static_cast<float*>(dv), heads, sq, sk,
            causal, scale, dr, bias);
    return cudaGetLastError();
  }
}

// bf16/fp16: the dQ kernel of attention_bwd_sm90.cuh, kBwdWarpgroups consumer
// warpgroups (64 query rows each) a block, with DBIAS storing into the
// caller's zero-filled dbias; fp32: flash_bwd_dq_kernel.
template <typename T, int D, bool SEGS, bool DROP, bool BIAS, bool DBIAS>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const int* q_ids, const int* kv_ids, const void* dout,
                      const float* lse, const float* delta, void* dq,
                      float* dbias, int bh, int heads, int sq, int sk,
                      int causal, float scale, attn::Dropout dr,
                      attn::Bias bias, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    const attn::sm90::BwdParams prm{
        q_ids, kv_ids, lse, delta, dq, nullptr, nullptr, dbias, heads, sq, sk,
        causal, scale, dr, bias};
    return attn::sm90::launch_dq<D, kBwdWarpgroups, SEGS, DROP, BIAS, DBIAS,
                                 T>(
        q, k, v, dout, prm, bh, stream);
  } else {
    using L = DqTiles<D>;
    constexpr int kBytes = L::BYTES + attn::id_bytes<SEGS>(L::QT) +
                           2 * attn::id_bytes<SEGS>(L::KT);
    static bool opted = false;
    cudaError_t err = attn::opt_in(
        flash_bwd_dq_kernel<D, SEGS, DROP, BIAS, DBIAS>, kBytes, &opted);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D, SEGS, DROP, BIAS, DBIAS>
        <<<dim3((sq + L::QT - 1) / L::QT, bh), L::kThreads, kBytes, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), q_ids, kv_ids,
            static_cast<const float*>(dout), lse, delta,
            static_cast<float*>(dq), dbias, heads, sq, sk, causal, scale, dr,
            bias);
    return cudaGetLastError();
  }
}

bool bad_shape(int bh, int sq, int sk) {
  return bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0;
}

}  // namespace
}  // namespace flash

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, each taken by its own build
// (attention_flash_f32.cu with ATTN_F32, this source, attention_flash_f16.cu
// with ATTN_F16); head dims 64 and 128; q_ids/kv_ids both null
// or (bh / heads, sq) and (bh / heads, sk) int32 segment ids; bias null or
// fp32, the (sq, sk) slab of row bh = b_i * heads + h_i at b_i *
// bias_stride_b + h_i * bias_stride_h (0 on a broadcast dim); seed,
// keep_threshold, inv_keep the dropout hash's uint32 seed and threshold and
// the fp32 1 / (1 - rate), inv_keep = 0 for no dropout; DBIAS, the dQ
// entry's non-null dbias (only with a bias).  Each (dtype, d) has eight
// instances, with and without SEGS, DROP and BIAS, and the dQ kernel four
// more, the BIAS ones with DBIAS.  Each entry returns a cudaError_t code
// (0 = success).
#define FLASH_BIAS(CALL, T, D, SEGS, DROP)                                 \
  (biased ? (emit ? CALL(T, D, SEGS, DROP, true, true)                     \
                  : CALL(T, D, SEGS, DROP, true, false))                   \
          : CALL(T, D, SEGS, DROP, false, false))
#define FLASH_DISPATCH_TD(CALL, T, D)                                      \
  if (segs) {                                                              \
    if (drop) return FLASH_BIAS(CALL, T, D, true, true);                   \
    return FLASH_BIAS(CALL, T, D, true, false);                            \
  }                                                                        \
  if (drop) return FLASH_BIAS(CALL, T, D, false, true);                    \
  return FLASH_BIAS(CALL, T, D, false, false)
#define FLASH_DISPATCH(CALL, DBIAS)                                        \
  if (flash::bad_shape(bh, sq, sk) ||                                      \
      attn::bad_ids(q_ids, kv_ids, bh, heads) ||                           \
      attn::bad_bias(bias, bias_stride_b, bias_stride_h, bh, heads, DBIAS)) \
    return cudaErrorInvalidValue;                                          \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                      \
  const bool segs = q_ids != nullptr;                                      \
  const bool drop = inv_keep != 0.0f;                                      \
  const bool biased = bias != nullptr;                                     \
  const bool emit = (DBIAS) != nullptr;                                    \
  const attn::Dropout dr{seed, keep_threshold, inv_keep};                  \
  const attn::Bias bs{bias, bias_stride_b, bias_stride_h};                 \
  if (dtype == FLASH_DTYPE && d == 128) {                                  \
    FLASH_DISPATCH_TD(CALL, FLASH_T, 128);                                 \
  }                                                                        \
  if (dtype == FLASH_DTYPE && d == 64) {                                   \
    FLASH_DISPATCH_TD(CALL, FLASH_T, 64);                                  \
  }                                                                        \
  return cudaErrorInvalidValue
#if defined(ATTN_F16)
#define FLASH_DTYPE 2
#define FLASH_T flash::f16
#elif defined(ATTN_F32)
#define FLASH_DTYPE 0
#define FLASH_T float
#else
#define FLASH_DTYPE 1
#define FLASH_T flash::bf16
#endif

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, const int* q_ids,
              const int* kv_ids, const float* bias, void* out, float* lse,
              int bh, int heads, int sq, int sk, int d, int dtype, int causal,
              int bias_stride_b, int bias_stride_h, float scale, unsigned seed,
              unsigned keep_threshold, float inv_keep, void* stream) {
#define CALL(T, D, SEGS, DROP, BIAS, DBIAS)                                \
  flash::launch_fwd<T, D, SEGS, DROP, BIAS>(q, k, v, q_ids, kv_ids, out, lse,   \
                                      bh, heads, sq, sk, causal, scale, dr, \
                                      bs, s)
  FLASH_DISPATCH(CALL, static_cast<float*>(nullptr));
#undef CALL
}

// lse, delta: (bh, sq) fp32, delta = rowsum(dout * out).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const int* q_ids, const int* kv_ids, const float* bias,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int bh, int heads, int sq, int sk, int d,
                  int dtype, int causal, int bias_stride_b, int bias_stride_h,
                  float scale, unsigned seed, unsigned keep_threshold,
                  float inv_keep, void* stream) {
#define CALL(T, D, SEGS, DROP, BIAS, DBIAS)                                \
  flash::launch_dkv<T, D, SEGS, DROP, BIAS>(q, k, v, q_ids, kv_ids, dout, lse,  \
                                      delta, dk, dv, bh, heads, sq, sk,    \
                                      causal, scale, dr, bs, s)
  FLASH_DISPATCH(CALL, static_cast<float*>(nullptr));
#undef CALL
}

// dbias: null, or with a bias the (bh, sq, sk) fp32 gradient of the biased
// scores, zero-filled by the caller: the DBIAS instance stores it.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const int* q_ids, const int* kv_ids, const float* bias,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, float* dbias, int bh, int heads, int sq, int sk,
                 int d, int dtype, int causal, int bias_stride_b,
                 int bias_stride_h, float scale, unsigned seed,
                 unsigned keep_threshold, float inv_keep, void* stream) {
#define CALL(T, D, SEGS, DROP, BIAS, DBIAS)                                \
  flash::launch_dq<T, D, SEGS, DROP, BIAS, DBIAS>(q, k, v, q_ids, kv_ids, dout, \
                                     lse, delta, dq, dbias, bh, heads, sq, \
                                     sk, causal, scale, dr, bs, s)
  FLASH_DISPATCH(CALL, dbias);
#undef CALL
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
