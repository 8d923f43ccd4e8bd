// The bf16 and fp16 attention backward for Hopper (sm_90a): TMA loads, a
// producer warpgroup and consumer warpgroups, wgmma products with the
// scores, the score gradients and the accumulated gradients in registers.
// The short and mid entries (attention_common.cuh's attn::bwd) launch both
// kernels for bf16 and fp16 inputs, after the delta pass, and the flash
// entries (attention_flash.cu's flash_bwd_dkv and flash_bwd_dq) one each,
// with the caller's delta; their fp32 instances keep SIMT FMA kernels in
// those files (wgmma has no fp32 form, and TF32 would break the fp32
// parity that Precision.HIGHEST asks for).  The element type T (bf16 or
// fp16) is a template parameter, with the forward's Elem<T> conversions.
//
// Replaces, for bf16 and fp16 inputs:
//   apex_tpu/ops/attention_short.py::_short_bwd_kernel (:215, call :444)
//   apex_tpu/ops/attention_mid.py::_mid_bwd_kernel     (:308, call :639)
//   apex_tpu/ops/attention.py::_fa_bwd_dkv_kernel      (:429, call :673)
//   apex_tpu/ops/attention.py::_fa_bwd_dq_kernel       (:534, call :722)
//
// Function: exactly what _short_bwd_plain (ops/attention_short.py)
// computes, which _mid_bwd_plain reuses and _flash_bwd_plain
// (ops/attention_flash.py) repeats without an lse cotangent.  s = (q . k) *
// scale (+ bias) in fp32, p = exp(s - lse) with masked pairs exactly 0, dz
// = p * (dp - delta), where delta = rowsum(dO * O) - dlse comes from the
// delta pass; with dropout dV takes the dropped, scaled p and dz the
// dropped, scaled dp; p and dz * scale are rounded to T as the
// operands of dV, dK and dQ.  In fp16 that rounding is where the range
// ends: dz scales with the loss scale, and a dz * scale past 65504 becomes
// inf (round to nearest, no saturation), reaches dQ/dK and makes the
// scaler skip the step, as the plain versions' fp16 rounding of the same
// operand does.  Causal is top-left aligned (key <= query
// by index); sq and sk need not be multiples of a tile; query rows at or
// past sq stay out of dK/dV.
// The variants are template flags with the predicates of
// attention_tiles.cuh: SEGS (a row that sees no key has an lse of about
// -1e30 and contributes p = 0), DROP (JAX's hash over the global bh and
// the absolute positions), BIAS (a row the bias alone hides stays
// visible), and DBIAS (the dQ kernel also stores every pair's unscaled
// fp32 dz into the caller's zero-filled (bh, sq, sk) tensor; tiles the
// causal walk skips stay 0).
//
// Two kernels and no atomics: the result is the same bits on every call,
// as the JAX kernels' sequential accumulation gives.  The dQ kernel
// recomputes S and dP (7 products a pair instead of FA3's 5 with dQ
// accumulated by fp32 atomics across key tiles).  Each has its own
// launcher (launch_dkv, launch_dq): the flash rung's backward is the same
// function on the same (bh, s, D) layout behind two entries, with its
// delta from flash_delta.
//
// Design:
//  - dK/dV kernel: one block per (bh, key tile of 64 * NC keys), NC
//    consumer warpgroups of 64 keys each.  K and V land once; 64-row query
//    tiles of Q and dO, with their 64 lse and delta values, stream through
//    a ring of ATTN_BWD_STAGES stages from the causal diagonal down.  S^T =
//    K . Q^T and dP^T = V . dO^T by wgmma, both operands K-major in shared
//    memory, each its own commit group, so the replay of p runs on S^T
//    while dP^T is still in the tensor cores.  The accumulators are (key,
//    query): a thread's rows are keys and its columns queries, so lse and
//    delta are read by column (from the stage, two adjacent columns in one
//    8-byte load), and every index of a (query, key) pair is swapped: the
//    hash drop_keep(dr, hrow, qi, kj), the causal test kj <= qi, the ids
//    kid[row] == qid[col], the bias element bslab[qi * sk + kj].  P^T (the
//    dropped, scaled p) and dz^T * scale are converted to T in registers
//    as the register A operand of dV += P^T . dO and dK += dz^T . Q, with
//    dO and Q read MN-major through the descriptor's transpose bit (as the
//    forward reads V).  dV is issued as soon as P^T is packed and runs
//    while dz is formed.  dK and dV stay in fp32 registers until the
//    epilogue, which stores rows below sk.
//  - dQ kernel: one block per (bh, query tile of 64 * NC rows), NC
//    consumer warpgroups of 64 rows each.  Q and dO land once; 64-key
//    tiles of K and V stream through the ring up to the causal diagonal.
//    S = Q . K^T and dP = dO . V^T (two commit groups), p, then dz; DBIAS
//    stores dz from registers (two adjacent keys in one 8-byte store where
//    sk is even); dQ += dz . K with dz * scale in registers and K MN-major.
//    dQ stays in registers until the epilogue.
//  - Warp specialisation as in the forward (attention_fwd_sm90.cuh, whose
//    PTX wrappers, descriptors and tensor-map encoder this file uses): one
//    producer warpgroup whose first thread issues every TMA load, and
//    setmaxnreg moving registers to the consumers (24 and 240 with two
//    consumer warpgroups, 24 and 232 with one; the short entry builds one,
//    the mid entry two, ATTN_BWD_WARPGROUPS; the flash entries two for
//    each kernel, chosen in attention_flash.cu).  With 64-row tiles a
//    dK/dV thread holds S^T, dP^T, dK and dV: 32 + 32 + D / 2 + D / 2 fp32
//    registers (192 at d = 128); a dQ thread 32 + 32 + D / 2.
//  - lse and delta of a query tile are stored into its stage by the 32
//    lanes of the producer's second warp (0 past sq), each of which
//    arrives on the stage's full barrier beside the TMA bytes: a 1-D TMA
//    box over the flattened (bh * sq) rows would start at an address that
//    is not 16-byte aligned wherever sq % 4 != 0, which the card refuses
//    as an illegal instruction.  Q and dO rows past sq land as zeros (3-D
//    maps), so dp = 0 there too.
//  - The predicate runs only where a tile needs it: in dK/dV the causal
//    diagonal, a query tile that ends past sq, and every tile with SEGS
//    (keys past sk are rows no store takes, so they need none); in dQ the
//    causal diagonal, the ragged last key tile (K and V rows there are 0,
//    but dz must be exactly 0 in dQ's sum over keys), and every tile with
//    SEGS.  Interior tiles take a path without it.  A masked score is the
//    forward's -2e30 sentinel, so p = exp2((s - lse) log2 e) is exactly 0
//    without a select, also for a SEGS row whose lse is about -1e30, while
//    a score the bias alone sets to -1e30 stays visible.  A warpgroup whose
//    whole tile is above the diagonal skips the products (it still waits
//    for the stage and releases it, so the ring's phases stay in order).
//  - The bias is read from global memory into registers while the
//    products run, with the row and column clamped into the slab (no
//    predicate): in the accumulator layout the eight lanes that share a
//    column of the dK/dV kernel read eight adjacent keys of one query row,
//    so each warp load touches four 32-byte rows of the slab, as many
//    sectors as the (query, key) layout of the dQ kernel, which reads two
//    adjacent keys in one 8-byte load where sk is even: no shared-memory
//    transpose is needed.
//  - Segment ids: a streamed tile's 64 ids are read once, two a lane,
//    while its products run, and each thread takes its columns' ids from
//    the lane that holds them by a shuffle.  Read a column at a time inside
//    the predicate they made BERT-large's short_bwd_seg 2.05x the instance
//    without ids (two consumer warpgroups); read so, 1.22x (one; PERF.md).
//  - Causal blocks run heaviest first: dK/dV on a (bh, key tile) grid in
//    order (the first key tile sees the most query tiles), dQ with the
//    query tiles reversed.  Every block reads its own bh, which the
//    dropout hash, the id row bh / heads and the bias slab take.
//
// What bounds it on the card: at the flagship's training shape (b*h = 64,
// s = 1024, d = 128, causal) the backward's five products a pair are
// 4.3e10 flops, 0.0435 ms of tensor-core time, against 0.040 ms of memory
// time (q, k, v, out, dout read, dq, dk, dv written once); the seven this
// design runs take at least 0.061 ms.  On an H100 (700 W, chip_smoke.py
// phase 2) it runs 0.18 ms there, and 0.072 ms at the short rung's b*h =
// 64, s = 512, about SDPA's backward.  At the Llama mode's b*h = 16, s =
// 4096 (the flash rung, four times the flagship's pairs) the dK/dV kernel's
// four products a pair take at least 0.139 ms and the dQ kernel's three
// 0.104 ms; they run 0.25 and 0.18 ms (tools/bwd_rows.py), together about
// SDPA's backward.  What the design leaves undone (PERF.md): no overlap
// of one tile's elementwise work with the next tile's products inside a
// warpgroup, and no ping-pong of two warpgroups, as FA3 does; the
// epilogues store from registers rather than through TMA.

#pragma once

#include "attention_fwd_sm90.cuh"

// Stages in the ring of streamed tiles: 2 on every rung (a third gave the
// flash rung nothing, attention_flash.cu); a source may set its own before
// the include, as tools/bwd_rows.py builds 2 and 3.
#ifndef ATTN_BWD_STAGES
#define ATTN_BWD_STAGES 2
#endif

namespace attn {
namespace sm90 {
namespace {

// rows of a streamed tile: queries (dK/dV kernel), keys (dQ kernel)
constexpr int kBT = 64;
constexpr int kBwdStages = ATTN_BWD_STAGES;   // stages in the ring

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The segment ids of a streamed tile's kBT positions t0.. (0 at or past
// n), read while the tile's products run, two a lane: lane l holds
// positions t0 + 2 l and t0 + 2 l + 1.
__device__ __forceinline__ int2 tile_ids(const int* ids, int t0, int n,
                                         int lane) {
  const int t = t0 + 2 * lane;
  return make_int2(t < n ? __ldg(ids + t) : 0,
                   t + 1 < n ? __ldg(ids + t + 1) : 0);
}

// The ids of a thread's columns 8 j + c0 and 8 j + c0 + 1 of the tile,
// from the lane that holds them (4 j + c0 / 2).
__device__ __forceinline__ int2 column_ids(int2 ids, int j, int c0) {
  const int src = 4 * j + c0 / 2;
  return make_int2(__shfl_sync(0xffffffffu, ids.x, src),
                   __shfl_sync(0xffffffffu, ids.y, src));
}

// ---------------------------------------------------------------- layouts

// dK/dV block, in bytes from a 1024-byte-aligned base: K and V (D / 64
// slabs of KB rows x 128 bytes each), then kBwdStages stages of Q and dO
// (D / 64 slabs of kBT rows each), then each stage's lse and delta (kBT
// floats each), then the mbarriers (K/V, kBwdStages full, kBwdStages
// empty).
template <int D, int NC>
struct DkvSmem {
  static constexpr int KB = 64 * NC;
  static constexpr int SLABS = D / 64;
  static constexpr int K_SLAB = KB * 128;
  static constexpr int Q_SLAB = kBT * 128;
  static constexpr int V_OFF = SLABS * K_SLAB;
  static constexpr int STAGE_OFF = 2 * SLABS * K_SLAB;
  static constexpr int STAGE = 2 * SLABS * Q_SLAB;   // Q, then dO
  static constexpr int ROW_OFF = STAGE_OFF + kBwdStages * STAGE;
  static constexpr int ROW_STAGE = 2 * kBT * 4;      // lse, then delta
  static constexpr int BAR_OFF = ROW_OFF + kBwdStages * ROW_STAGE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * kBwdStages) + 1024;
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 232;
};

// dQ block: Q and dO (D / 64 slabs of QB rows each), then kBwdStages
// stages of K and V (D / 64 slabs of kBT rows each), then the mbarriers
// (Q/dO, kBwdStages full, kBwdStages empty).
template <int D, int NC>
struct DqSmem {
  static constexpr int QB = 64 * NC;
  static constexpr int SLABS = D / 64;
  static constexpr int Q_SLAB = QB * 128;
  static constexpr int K_SLAB = kBT * 128;
  static constexpr int DO_OFF = SLABS * Q_SLAB;
  static constexpr int STAGE_OFF = 2 * SLABS * Q_SLAB;
  static constexpr int STAGE = 2 * SLABS * K_SLAB;   // K, then V
  static constexpr int BAR_OFF = STAGE_OFF + kBwdStages * STAGE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * kBwdStages) + 1024;
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 232;
};

struct BwdParams {
  const int* q_ids;     // (bh / heads, sq) int32, with SEGS
  const int* kv_ids;    // (bh / heads, sk) int32, with SEGS
  const float* lse;     // (bh, sq): the dQ kernel reads its rows' here
  const float* delta;   // (bh, sq)
  void* dq;             // (bh, sq, D) of the inputs' type
  void* dk;             // (bh, sk, D)
  void* dv;             // (bh, sk, D)
  float* dbias;         // (bh, sq, sk) fp32, zero-filled, with DBIAS
  int heads, sq, sk, causal;
  float scale;
  Dropout dr;
  Bias bias;
};

// The K-major k-steps of an m64 x N x D product: D / 16 steps of 16
// columns, 32 bytes apart in a 128-byte slab row, slabs A_SLAB and B_SLAB
// bytes apart.  accumulate = 0 on the first step overwrites d.
template <typename T, int N, int D, int A_SLAB, int B_SLAB>
__device__ __forceinline__ void product_kmajor(float (&d)[N / 2], uint64_t da,
                                               uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t a = ((kk / 4) * (uint64_t)A_SLAB + (kk % 4) * 32) >> 4;
    const uint64_t b = ((kk / 4) * (uint64_t)B_SLAB + (kk % 4) * 32) >> 4;
    wgmma_ss<T, N>(d, da + a, db + b, kk > 0);
  }
}

// d += A . B over kBT rows of k: A the T fragments in registers (the
// packed accumulator of a 64 x kBT tile), B a kBT x D tile read MN-major
// (transpose bit; 16 rows of 128 bytes a k-step, the two 64-column slabs
// of d = 128 LBO apart in the descriptor).
template <typename T, int D>
__device__ __forceinline__ void product_rs(float (&d)[D / 2],
                                           const uint32_t (&a)[kBT / 4],
                                           uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < kBT / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    wgmma_rs<T, D>(d, f, db + ((kk * 2048) >> 4));
  }
}

// ------------------------------------------------------------ dK/dV kernel

// p of a (key, query) tile held in S (the accumulator of S^T = K . Q^T),
// in place, and P, the dropped and scaled p as T A fragments of dV +=
// P^T . dO; keep collects the thread's kept pairs (DROP).  Element i of S
// is key kj[(i >> 1) & 1] and query q0 + 8 (i >> 2) + c0 + (i & 1); qids
// are the query tile's ids (tile_ids).
template <typename T, bool MASK, bool SEGS, bool DROP, bool BIAS>
__device__ __forceinline__ void dkv_probs(
    float (&S)[kBT / 2], const float (&bv)[kBT / 2], uint32_t (&P)[kBT / 4],
    uint32_t& keep, const float* lse_s, const int (&kj)[2],
    const int (&kid)[2], int2 qids, int q0, int c0, unsigned hrow,
    const BwdParams& p) {
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j) {
    const float2 lse = *reinterpret_cast<const float2*>(lse_s + 8 * j + c0);
    const int qi[2] = {q0 + 8 * j + c0, q0 + 8 * j + c0 + 1};
    int qid[2] = {0, 0};
    if constexpr (MASK && SEGS) {
      const int2 c = column_ids(qids, j, c0);
      qid[0] = c.x;
      qid[1] = c.y;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        float x = S[i] * p.scale;
        if constexpr (BIAS) x = __fadd_rn(x, bv[i]);
        if constexpr (MASK) {
          const bool vis = qi[e] < p.sq && (!p.causal || kj[r] <= qi[e]) &&
                           (!SEGS || kid[r] == qid[e]);
          x = vis ? x : kMasked;
        }
        const float pr = exp2f((x - (e ? lse.y : lse.x)) * kLog2e);
        S[i] = pr;
        v[e] = pr;
        if constexpr (DROP) {
          const bool kept = drop_keep(p.dr, hrow, qi[e], kj[r]);
          keep |= static_cast<uint32_t>(kept) << i;
          v[e] = kept ? pr * p.dr.inv_keep : 0.0f;
        }
      }
      P[2 * j + r] = pack2<T>(v[0], v[1]);
    }
  }
}

// dz = p * (dp - delta) of the same tile, dp dropped and scaled where DROP
// dropped p, and Z = dz * scale as T A fragments of dK += dz^T . Q.
template <typename T, bool DROP>
__device__ __forceinline__ void dkv_dz(const float (&S)[kBT / 2],
                                       const float (&dP)[kBT / 2],
                                       uint32_t (&Z)[kBT / 4], uint32_t keep,
                                       const float* delta_s, int c0,
                                       const BwdParams& p) {
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + c0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        float dp = dP[i];
        if constexpr (DROP) {
          dp = (keep >> i) & 1u ? dp * p.dr.inv_keep : 0.0f;
        }
        v[e] = S[i] * (dp - (e ? dl.y : dl.x)) * p.scale;
      }
      Z[2 * j + r] = pack2<T>(v[0], v[1]);
    }
  }
}

// q, k, v, dout: the tensor maps of (bh, sq|sk, D) T; grid (bh, key
// tiles).
template <typename T, int D, int NC, bool SEGS, bool DROP, bool BIAS>
__global__ void __launch_bounds__(DkvSmem<D, NC>::THREADS, NC == 1 ? 2 : 1)
bwd_dkv_kernel(__grid_constant__ const CUtensorMap tq,
               __grid_constant__ const CUtensorMap tk,
               __grid_constant__ const CUtensorMap tv,
               __grid_constant__ const CUtensorMap tdo, const BwdParams p) {
  using L = DkvSmem<D, NC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t kvbar = base + L::BAR_OFF;
  const uint32_t full0 = kvbar + 8;
  const uint32_t empty0 = kvbar + 8 + 8 * kBwdStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const long bh = blockIdx.x;
  const int k0 = blockIdx.y * L::KB;
  // causal: query tiles wholly above the block's first key see none of it
  const int q_begin = p.causal ? (k0 / kBT) * kBT : 0;
  const int n_tiles = q_begin < p.sq ? (p.sq - q_begin + kBT - 1) / kBT : 0;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    // a stage is full once its TMA bytes have landed and the 32 lanes of
    // the producer's second warp have stored its lse and delta
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------- producer
    regs_dec<L::PRODUCER_REGS>();
    if (tid / 32 == 1 && n_tiles > 0) {
      // lse and delta of each query tile (0 past sq), two a lane: a 1-D
      // TMA box would start at the unaligned row bh * sq + q0
      const float* lse = p.lse + bh * p.sq;
      const float* delta = p.delta + bh * p.sq;
      float* rows0 = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                              L::ROW_OFF);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kBwdStages;
        const int use = t / kBwdStages;
        if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
        float* rows = rows0 + st * (L::ROW_STAGE / 4);
        for (int i = tid % 32; i < kBT; i += 32) {
          const int qi = q_begin + t * kBT + i;
          rows[i] = qi < p.sq ? __ldg(lse + qi) : 0.0f;
          rows[kBT + i] = qi < p.sq ? __ldg(delta + qi) : 0.0f;
        }
        mbar_arrive(full0 + 8 * st);
      }
    }
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(kvbar, 2 * L::KB * D * 2);
      for (int s = 0; s < L::SLABS; ++s) {
        tma_load(base + s * L::K_SLAB, &tk, kvbar, 64 * s, k0, (int)bh);
        tma_load(base + L::V_OFF + s * L::K_SLAB, &tv, kvbar, 64 * s, k0,
                 (int)bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kBwdStages;
        const int use = t / kBwdStages;
        const int q0 = q_begin + t * kBT;
        const uint32_t full = full0 + 8 * st;
        if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
        mbar_expect_tx(full, 2 * kBT * D * 2);
        const uint32_t qdst = base + L::STAGE_OFF + st * L::STAGE;
        const uint32_t dodst = qdst + L::SLABS * L::Q_SLAB;
        for (int s = 0; s < L::SLABS; ++s) {
          tma_load(qdst + s * L::Q_SLAB, &tq, full, 64 * s, q0, (int)bh);
          tma_load(dodst + s * L::Q_SLAB, &tdo, full, 64 * s, q0, (int)bh);
        }
      }
      // stay until the consumers have released every stage in flight
      for (int t = max(0, n_tiles - kBwdStages); t < n_tiles; ++t) {
        mbar_wait(empty0 + 8 * (t % kBwdStages), (t / kBwdStages) & 1);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    regs_inc<L::CONSUMER_REGS>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c0 = 2 * (lane % 4);   // first column of each 8-wide block
    const int kw0 = k0 + wg * 64;
    const int kj[2] = {kw0 + warp * 16 + lane / 4,
                       kw0 + warp * 16 + lane / 4 + 8};
    const long brow = SEGS ? bh / p.heads : 0;
    int kid[2] = {0, 0};
    const int* qidb = nullptr;
    if constexpr (SEGS) {
      const int* kidb = p.kv_ids + brow * p.sk;
      for (int r = 0; r < 2; ++r) {
        kid[r] = kj[r] < p.sk ? __ldg(kidb + kj[r]) : 0;
      }
      qidb = p.q_ids + brow * p.sq;
    }
    const unsigned hrow = DROP ? drop_row(p.dr, bh) : 0u;
    // the bias of key kj[r] and query qi is bcol[r][qi * sk], both clamped
    // into the slab: the pairs past it are masked or land in no store
    const float* bcol[2] = {nullptr, nullptr};
    if constexpr (BIAS) {
      const float* bslab = bias_slab(p.bias, bh, p.heads);
      for (int r = 0; r < 2; ++r) bcol[r] = bslab + min(kj[r], p.sk - 1);
    }

    float dK[D / 2], dV[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dK[i] = 0.0f;
      dV[i] = 0.0f;
    }
    // this warpgroup's 64 rows of each K and V slab
    const uint64_t desc_k = gmma_desc(base + wg * 64 * 128, 16, 1024);
    const uint64_t desc_v =
        gmma_desc(base + L::V_OFF + wg * 64 * 128, 16, 1024);
    const unsigned char* gbase = smem_raw + (base - raw);
    if (n_tiles > 0) mbar_wait(kvbar, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kBwdStages;
      const int q0 = q_begin + t * kBT;
      mbar_wait(full0 + 8 * st, (t / kBwdStages) & 1);
      // causal: a tile wholly above this warpgroup's keys adds nothing
      if (!p.causal || q0 + kBT - 1 >= kw0) {
        const uint32_t qa = base + L::STAGE_OFF + st * L::STAGE;
        const uint32_t doa = qa + L::SLABS * L::Q_SLAB;
        const float* lse_s = reinterpret_cast<const float*>(
            gbase + L::ROW_OFF + st * L::ROW_STAGE);
        const float* delta_s = lse_s + kBT;

        // S^T = K . Q^T and dP^T = V . dO^T, one commit group each
        float S[kBT / 2], dP[kBT / 2];
        wgmma_fence();
        product_kmajor<T, kBT, D, L::K_SLAB, L::Q_SLAB>(
            S, desc_k, gmma_desc(qa, 16, 1024));
        wgmma_commit();
        product_kmajor<T, kBT, D, L::K_SLAB, L::Q_SLAB>(
            dP, desc_v, gmma_desc(doa, 16, 1024));
        wgmma_commit();
        // the tile's query ids and the bias of the thread's pairs, read
        // while the products run
        [[maybe_unused]] int2 qids = make_int2(0, 0);
        if constexpr (SEGS) qids = tile_ids(qidb, q0, p.sq, lane);
        [[maybe_unused]] float bv[kBT / 2];
        if constexpr (BIAS) {
#pragma unroll
          for (int i = 0; i < kBT / 2; ++i) {
            const int qi = q0 + 8 * (i >> 2) + c0 + (i & 1);
            bv[i] = __ldg(bcol[(i >> 1) & 1] + (long)min(qi, p.sq - 1) * p.sk);
          }
        }
        wgmma_wait_one();
        fence_regs(S);

        const bool masked = SEGS || q0 + kBT > p.sq ||
                            (p.causal && q0 < kw0 + 63);
        uint32_t P[kBT / 4];
        uint32_t keep = 0;
        if (masked) {
          dkv_probs<T, true, SEGS, DROP, BIAS>(S, bv, P, keep, lse_s, kj,
                                               kid, qids, q0, c0, hrow, p);
        } else {
          dkv_probs<T, false, SEGS, DROP, BIAS>(S, bv, P, keep, lse_s, kj,
                                                kid, qids, q0, c0, hrow, p);
        }
        // dV += P^T . dO, running while dz is formed
        fence_regs(dV);
        wgmma_fence();
        product_rs<T, D>(dV, P, gmma_desc(doa, L::Q_SLAB, 1024));
        wgmma_commit();
        wgmma_wait_one();   // dP^T has landed; dV may still run
        fence_regs(dP);

        uint32_t Z[kBT / 4];
        dkv_dz<T, DROP>(S, dP, Z, keep, delta_s, c0, p);
        fence_regs(dK);
        wgmma_fence();
        product_rs<T, D>(dK, Z, gmma_desc(qa, L::Q_SLAB, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dV);
        fence_regs(dK);
        fence_u32(P);
        fence_u32(Z);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // store the thread's two key rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kj[r] >= p.sk) continue;
      using T2 = typename Elem<T>::T2;
      const long at = (bh * p.sk + kj[r]) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<T2*>(static_cast<T*>(p.dk) + at + 8 * j) =
            Elem<T>::pair(dK[4 * j + 2 * r], dK[4 * j + 2 * r + 1]);
        *reinterpret_cast<T2*>(static_cast<T*>(p.dv) + at + 8 * j) =
            Elem<T>::pair(dV[4 * j + 2 * r], dV[4 * j + 2 * r + 1]);
      }
    }
  }
}

// --------------------------------------------------------------- dQ kernel

// p of a (query, key) tile held in S (the accumulator of S = Q . K^T), in
// place.  Element i of S is query qi[(i >> 1) & 1] and key k0 + 8 (i >> 2)
// + c0 + (i & 1); kids are the key tile's ids (tile_ids).
template <bool MASK, bool SEGS, bool BIAS>
__device__ __forceinline__ void dq_probs(float (&S)[kBT / 2],
                                         const float (&bv)[kBT / 2],
                                         const int (&qi)[2],
                                         const int (&qid)[2],
                                         const float (&lse)[2], int2 kids,
                                         int k0, int c0,
                                         const BwdParams& p) {
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j) {
    [[maybe_unused]] int2 kid2 = make_int2(0, 0);
    if constexpr (MASK && SEGS) kid2 = column_ids(kids, j, c0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kj = k0 + 8 * j + c0 + e;
      [[maybe_unused]] const int kid = e ? kid2.y : kid2.x;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float x = S[i] * p.scale;
        if constexpr (BIAS) x = __fadd_rn(x, bv[i]);
        if constexpr (MASK) {
          const bool vis = kj < p.sk && (!p.causal || kj <= qi[r]) &&
                           (!SEGS || qid[r] == kid);
          x = vis ? x : kMasked;
        }
        S[i] = exp2f((x - lse[r]) * kLog2e);
      }
    }
  }
}

// dz = p * (dp - delta), dp dropped and scaled (DROP); with DBIAS dz is
// stored unscaled to the rows dbrow[r] (rows below sq, keys below sk); Z =
// dz * scale as T A fragments of dQ += dz . K.
template <typename T, bool DROP, bool DBIAS>
__device__ __forceinline__ void dq_dz(const float (&S)[kBT / 2],
                                      const float (&dP)[kBT / 2],
                                      uint32_t (&Z)[kBT / 4],
                                      const int (&qi)[2], const float (&dl)[2],
                                      float* const (&dbrow)[2], bool pairs,
                                      int k0, int c0, unsigned hrow,
                                      const BwdParams& p) {
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j) {
    const int kj = k0 + 8 * j + c0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        float dp = dP[i];
        if constexpr (DROP) {
          dp = drop_keep(p.dr, hrow, qi[r], kj + e) ? dp * p.dr.inv_keep
                                                    : 0.0f;
        }
        v[e] = S[i] * (dp - dl[r]);
      }
      if constexpr (DBIAS) {
        if (qi[r] < p.sq) {
          float* d = dbrow[r] + kj;
          if (pairs && kj + 1 < p.sk) {
            *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
          } else {
            if (kj < p.sk) d[0] = v[0];
            if (kj + 1 < p.sk) d[1] = v[1];
          }
        }
      }
      Z[2 * j + r] = pack2<T>(v[0] * p.scale, v[1] * p.scale);
    }
  }
}

// q, k, v, dout: the tensor maps of (bh, sq|sk, D) T; grid (bh, query
// tiles).
template <typename T, int D, int NC, bool SEGS, bool DROP, bool BIAS,
          bool DBIAS>
__global__ void __launch_bounds__(DqSmem<D, NC>::THREADS, NC == 1 ? 2 : 1)
bwd_dq_kernel(__grid_constant__ const CUtensorMap tq,
              __grid_constant__ const CUtensorMap tk,
              __grid_constant__ const CUtensorMap tv,
              __grid_constant__ const CUtensorMap tdo, const BwdParams p) {
  static_assert(BIAS || !DBIAS, "dBias needs a bias");
  using L = DqSmem<D, NC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qbar = base + L::BAR_OFF;
  const uint32_t full0 = qbar + 8;
  const uint32_t empty0 = qbar + 8 + 8 * kBwdStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const long bh = blockIdx.x;
  const int tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * L::QB;
  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = p.causal ? min(p.sk, q0 + L::QB) : p.sk;
  const int n_tiles = (kv_end + kBT - 1) / kBT;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------- producer
    regs_dec<L::PRODUCER_REGS>();
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * L::QB * D * 2);
      for (int s = 0; s < L::SLABS; ++s) {
        tma_load(base + s * L::Q_SLAB, &tq, qbar, 64 * s, q0, (int)bh);
        tma_load(base + L::DO_OFF + s * L::Q_SLAB, &tdo, qbar, 64 * s, q0,
                 (int)bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kBwdStages;
        const int use = t / kBwdStages;
        const uint32_t full = full0 + 8 * st;
        if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
        mbar_expect_tx(full, 2 * kBT * D * 2);
        const uint32_t kdst = base + L::STAGE_OFF + st * L::STAGE;
        const uint32_t vdst = kdst + L::SLABS * L::K_SLAB;
        for (int s = 0; s < L::SLABS; ++s) {
          tma_load(kdst + s * L::K_SLAB, &tk, full, 64 * s, t * kBT, (int)bh);
          tma_load(vdst + s * L::K_SLAB, &tv, full, 64 * s, t * kBT, (int)bh);
        }
      }
      for (int t = max(0, n_tiles - kBwdStages); t < n_tiles; ++t) {
        mbar_wait(empty0 + 8 * (t % kBwdStages), (t / kBwdStages) & 1);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    regs_inc<L::CONSUMER_REGS>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c0 = 2 * (lane % 4);
    const int qw0 = q0 + wg * 64;
    const int qi[2] = {qw0 + warp * 16 + lane / 4,
                       qw0 + warp * 16 + lane / 4 + 8};
    float lse[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = qi[r] < p.sq;
      lse[r] = in ? __ldg(p.lse + bh * p.sq + qi[r]) : 0.0f;
      dl[r] = in ? __ldg(p.delta + bh * p.sq + qi[r]) : 0.0f;
    }
    const long brow = SEGS ? bh / p.heads : 0;
    int qid[2] = {0, 0};
    const int* kidb = nullptr;
    if constexpr (SEGS) {
      const int* qidb = p.q_ids + brow * p.sq;
      for (int r = 0; r < 2; ++r) {
        qid[r] = qi[r] < p.sq ? __ldg(qidb + qi[r]) : 0;
      }
      kidb = p.kv_ids + brow * p.sk;
    }
    const unsigned hrow = DROP ? drop_row(p.dr, bh) : 0u;
    // the bias rows of the thread's queries, clamped into the slab
    const float* bslab = BIAS ? bias_slab(p.bias, bh, p.heads) : nullptr;
    const float* bias_rows[2] = {nullptr, nullptr};
    if constexpr (BIAS) {
      for (int r = 0; r < 2; ++r) {
        bias_rows[r] = bslab + (long)min(qi[r], p.sq - 1) * p.sk;
      }
    }
    float* dbrow[2] = {nullptr, nullptr};
    if constexpr (DBIAS) {
      for (int r = 0; r < 2; ++r) {
        dbrow[r] = p.dbias + (bh * p.sq + qi[r]) * p.sk;
      }
    }
    // two adjacent keys of a row are one 8-byte load of the bias and one
    // 8-byte store of dBias where rows start 8-byte aligned (the first key
    // of a pair is even)
    const bool bias_pairs = BIAS && p.sk % 2 == 0 &&
                            reinterpret_cast<uintptr_t>(bslab) % 8 == 0;
    const bool pairs = DBIAS && p.sk % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(p.dbias) % 8 == 0;

    float dQ[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dQ[i] = 0.0f;
    // this warpgroup's 64 rows of each Q and dO slab
    const uint64_t desc_q = gmma_desc(base + wg * 64 * 128, 16, 1024);
    const uint64_t desc_do =
        gmma_desc(base + L::DO_OFF + wg * 64 * 128, 16, 1024);
    mbar_wait(qbar, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kBwdStages;
      const int k0 = t * kBT;
      mbar_wait(full0 + 8 * st, (t / kBwdStages) & 1);
      // causal: a key tile wholly past this warpgroup's rows adds nothing
      if (!p.causal || k0 <= qw0 + 63) {
        const uint32_t ka = base + L::STAGE_OFF + st * L::STAGE;
        const uint32_t va = ka + L::SLABS * L::K_SLAB;

        float S[kBT / 2], dP[kBT / 2];
        wgmma_fence();
        product_kmajor<T, kBT, D, L::Q_SLAB, L::K_SLAB>(
            S, desc_q, gmma_desc(ka, 16, 1024));
        wgmma_commit();
        product_kmajor<T, kBT, D, L::Q_SLAB, L::K_SLAB>(
            dP, desc_do, gmma_desc(va, 16, 1024));
        wgmma_commit();
        // the tile's key ids and the bias of the thread's pairs, read while
        // the products run
        [[maybe_unused]] int2 kids = make_int2(0, 0);
        if constexpr (SEGS) kids = tile_ids(kidb, k0, p.sk, lane);
        [[maybe_unused]] float bv[kBT / 2];
        if constexpr (BIAS) {
          if (bias_pairs && k0 + kBT <= p.sk) {
#pragma unroll
            for (int i = 0; i < kBT / 2; i += 2) {
              const float2 b = __ldg(reinterpret_cast<const float2*>(
                  bias_rows[(i >> 1) & 1] + k0 + 8 * (i >> 2) + c0));
              bv[i] = b.x;
              bv[i + 1] = b.y;
            }
          } else {
#pragma unroll
            for (int i = 0; i < kBT / 2; ++i) {
              const int kj = k0 + 8 * (i >> 2) + c0 + (i & 1);
              bv[i] = __ldg(bias_rows[(i >> 1) & 1] + min(kj, p.sk - 1));
            }
          }
        }
        wgmma_wait_one();
        fence_regs(S);

        const bool masked = SEGS || k0 + kBT > p.sk ||
                            (p.causal && k0 + kBT - 1 > qw0);
        if (masked) {
          dq_probs<true, SEGS, BIAS>(S, bv, qi, qid, lse, kids, k0, c0, p);
        } else {
          dq_probs<false, SEGS, BIAS>(S, bv, qi, qid, lse, kids, k0, c0, p);
        }
        wgmma_wait_all();
        fence_regs(dP);

        uint32_t Z[kBT / 4];
        dq_dz<T, DROP, DBIAS>(S, dP, Z, qi, dl, dbrow, pairs, k0, c0, hrow,
                              p);
        // dQ += dz . K: K read MN-major
        fence_regs(dQ);
        wgmma_fence();
        product_rs<T, D>(dQ, Z, gmma_desc(ka, L::K_SLAB, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dQ);
        fence_u32(Z);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // store the thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= p.sq) continue;
      T* o = static_cast<T*>(p.dq) + (bh * p.sq + qi[r]) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<typename Elem<T>::T2*>(o + 8 * j) =
            Elem<T>::pair(dQ[4 * j + 2 * r], dQ[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

// The dK/dV kernel of (bh, sq, D) q and dout against (bh, sk, D) k and v,
// NC consumer warpgroups (64 * NC keys) a block; lse and delta (bh, sq)
// fp32, delta = rowsum(dO * O) - dlse (attn_delta_kernel); T bf16 (the
// default) or fp16.
template <int D, int NC, bool SEGS, bool DROP, bool BIAS, typename T = bf16>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const BwdParams& prm, int bh,
                       cudaStream_t stream) {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  using L = DkvSmem<D, NC>;
  const int tiles = (prm.sk + L::KB - 1) / L::KB;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map<T>(&tq, q, D, prm.sq, bh, kBT) ||
      !encode_map<T>(&tk, k, D, prm.sk, bh, L::KB) ||
      !encode_map<T>(&tv, v, D, prm.sk, bh, L::KB) ||
      !encode_map<T>(&tdo, dout, D, prm.sq, bh, kBT)) {
    return cudaErrorInvalidValue;
  }
  static bool opted = false;
  cudaError_t err =
      opt_in(bwd_dkv_kernel<T, D, NC, SEGS, DROP, BIAS>, L::BYTES, &opted);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<T, D, NC, SEGS, DROP, BIAS>
      <<<dim3(bh, tiles), L::THREADS, L::BYTES, stream>>>(tq, tk, tv, tdo,
                                                          prm);
  return cudaGetLastError();
}

// The dQ kernel, NC consumer warpgroups (64 * NC query rows) a block; with
// DBIAS prm.dbias is the zero-filled (bh, sq, sk) fp32 gradient of the
// biased scores.  T bf16 (the default) or fp16.
template <int D, int NC, bool SEGS, bool DROP, bool BIAS, bool DBIAS,
          typename T = bf16>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const BwdParams& prm, int bh,
                      cudaStream_t stream) {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  using L = DqSmem<D, NC>;
  const int tiles = (prm.sq + L::QB - 1) / L::QB;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map<T>(&tq, q, D, prm.sq, bh, L::QB) ||
      !encode_map<T>(&tk, k, D, prm.sk, bh, kBT) ||
      !encode_map<T>(&tv, v, D, prm.sk, bh, kBT) ||
      !encode_map<T>(&tdo, dout, D, prm.sq, bh, L::QB)) {
    return cudaErrorInvalidValue;
  }
  static bool opted = false;
  cudaError_t err = opt_in(bwd_dq_kernel<T, D, NC, SEGS, DROP, BIAS, DBIAS>,
                           L::BYTES, &opted);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D, NC, SEGS, DROP, BIAS, DBIAS>
      <<<dim3(bh, tiles), L::THREADS, L::BYTES, stream>>>(tq, tk, tv, tdo,
                                                          prm);
  return cudaGetLastError();
}

// Both kernels of the bf16 or fp16 (T) backward, after the delta pass;
// dbias: null, or with DBIAS the zero-filled (bh, sq, sk) fp32 gradient of
// the biased scores.
template <int D, int NC, bool SEGS, bool DROP, bool BIAS, bool DBIAS,
          typename T = bf16>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const int* q_ids, const int* kv_ids,
                       const float* lse, const float* delta, void* dq,
                       void* dk, void* dv, float* dbias, int bh, int heads,
                       int sq, int sk, int causal, float scale, Dropout dr,
                       Bias bias, cudaStream_t stream) {
  const BwdParams prm{q_ids, kv_ids, lse, delta, dq, dk, dv, dbias, heads,
                      sq, sk, causal, scale, dr, bias};
  const cudaError_t err =
      launch_dkv<D, NC, SEGS, DROP, BIAS, T>(q, k, v, dout, prm, bh, stream);
  if (err != cudaSuccess) return err;
  return launch_dq<D, NC, SEGS, DROP, BIAS, DBIAS, T>(q, k, v, dout, prm, bh,
                                                      stream);
}

}  // namespace
}  // namespace sm90
}  // namespace attn
