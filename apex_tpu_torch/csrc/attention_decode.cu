// Paged decode attention for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/attention_decode.py::_decode_kernel, the Pallas
// TPU kernel behind fmha_decode: a few query rows per sequence (sq >= 1)
// attend to that sequence's K/V, which lives in a shared page pool
// (num_pages, h, page_size, d) addressed through a per-sequence page
// table.  Query row i of sequence b sits at position lengths[b] - sq + i
// and, causal, attends to cache positions <= its own (the cache already
// holds the query tokens' own K/V: write-before-attend).
//
// Translation from the TPU kernel:
//  - The TPU grid walks (b, head block, logical page) in order and
//    carries (m, l, acc) across the page axis in VMEM scratch; the page
//    table reaches the DMA engine through scalar prefetch.  Here the walk
//    over a sequence's positions is split into spans of fixed absolute
//    positions, [j * span, (j + 1) * span), one block each: the grid is
//    (span, head, sequence) (the many-row kernel adds its row tile to the
//    span axis), computed from the shapes alone (span_count: the pool's
//    pages_per_seq * page_size positions), never from lengths, so the
//    host never reads the lengths or the page table and a launch can be
//    captured in a CUDA graph.  A block whose span starts at or past what
//    its rows may see does no work.
//  - Each block writes its rows' unnormalised (m, l, acc) in fp32 to a
//    workspace of (b, h, sq, n_split) entries (acc: d floats, then m and
//    l: 2 floats), and the last block of a (sequence, head[, row tile])
//    merges them in span order 0, 1, 2, ...: M = max m_j, then
//    sum acc_j e^(m_j - M) / max(sum l_j e^(m_j - M), 1e-30).  It finds
//    out it is last by a __threadfence() and an atomicAdd ticket on an
//    int32 counter (the wrapper keeps one zeroed buffer per device and
//    stream), reads the other blocks' partials from L2 (__ldcg), and
//    resets the counter to 0 for the next launch: one launch a call, no
//    memset.  An empty span (l = 0) adds nothing and its acc is neither
//    written nor read.  With one span the block writes O directly and
//    touches no workspace; its O has the same bits as the merge of one
//    non-empty span (factor e^0 = 1).
//  - A row's result depends only on the positions it sees: the span
//    boundaries are absolute, inside a span the tokens are taken in
//    fixed tiles of 32 absolute positions, and the merge order is the
//    span order.  Never on where a prefill chunk began, the other rows of
//    the batch or the number of spans past the row's last position.
//    That is what keeps a prefix-cache hit bit-identical to a cold
//    admission.
//  - Bytes in flight: a block first turns its span's positions into
//    pool row indices through the page table (in shared memory), then
//    streams the span's K and V rows (and int8 scales) through a ring of
//    kStages tiles of 32 tokens in shared memory with cp.async (16 bytes
//    a copy, per row, so any page size works), kStages - 1 tiles ahead of
//    the tile being scored.  Over 48 KB of shared memory the launch sets
//    cudaFuncAttributeMaxDynamicSharedMemorySize (once per instance).
//  - Masking: tokens past the sequence's length are never staged, and a
//    staged token a row may not see (causal: past its position; tree: a
//    fresh row whose bit is clear) is selected away, never weighted by a
//    zero probability, so NaN in a masked row (the null page 0, where
//    idle slots and padding rows write) cannot reach a live row through
//    0 * NaN.
//  - The running max starts at the finite fill -1e30 (the JAX kernel's
//    _NEG_INF) and the final divide clamps l at 1e-30, so an idle slot
//    (length 0) sees no token and writes a finite zero row.
//  - The fused q-RoPE (rope_cos/rope_sin non-null, (b, sq, D/2) fp32):
//    each query row is rotated in fp32, q * cos + rotate_half(q) * sin,
//    then scaled, as the TPU body does (attention_decode.py:243-249), and
//    never rounded to q's dtype.  K was rotated once when it was written
//    to the cache.  The rotation is a template parameter.
//  - int8 pages (the TPU body's has_scales branch, :254-258): K and V
//    are int8 with one fp32 scale per (page, head, token, kv_block of
//    dims), (num_pages, h, page_size, nb), staged beside the rows and
//    applied in fp32 before the products.  The page type is a template
//    parameter too.
//  - Element types: q, out and 16-bit pages are fp32, bf16 or fp16 (the
//    opt levels O1-O3), one template parameter T of the same code; every
//    load widens to fp32 and the one store rounds to nearest even (an
//    fp16 output past 65504 is inf, as JAX's astype).  Like the attention
//    sources, one library an element type keeps each nvcc short: this
//    source holds fp32 and bf16, attention_decode_f16.cu (DECODE_F16)
//    the fp16 instances.
//
// The small kernel (paged_decode, paged_decode_int8: up to 8 rows): the
// block's 8 warps take the 32 tokens of a staged tile 4 each (token
// u * 8 + w); a lane holds D / 32 consecutive dims of q, of the K/V rows
// and of acc.  A warp scores its 4 tokens for every row at once
// (independent products and shuffles), then takes one max and one
// rescale a row per tile, not a dependent online-softmax step a token.
// At the span's end the warps' (m, l, acc) merge through shared memory.
// An instance for sq = 1 keeps one row's registers.
//
// The many-row kernel (paged_decode_rows; paged_decode_tree under an
// ancestor mask: up to 512 rows, or 31 under the tree mask) takes what
// the small kernel's per-warp registers cannot.  A block owns one
// (sequence, head, tile of 8, 16, 32 or 64 query rows, span); a warp owns
// 8 rows of the tile, each row's online-softmax state in the registers of
// one quarter of the warp's lanes, and a narrow tile's warps split the
// tile's tokens (row groups x token groups, below).  A warp scores 4
// tokens at a time, then each row adds its visible tokens in position
// order, one at a time; the token groups' states merge in a fixed order.
// A span past the tile's causal cut (the TPU kernel's p * ps < ln page
// skip, per tile) does no work.  It runs at 2 blocks an SM
// (DECODE_ROWS_MIN_BLOCKS: 128 registers, no spill).
//
// What bounds it on the card: every K/V byte is used for 2 flops per
// query row (~1 flop per byte at sq = 1 in bf16, far below the card's 20
// fp32 flops per byte), so it is bound by the bytes of the valid K/V
// rows, and what it needs is parallelism and bytes in flight: many
// blocks (a 4-slot batch of 8 heads at 4 x 2300 tokens and span 256 is
// 320 blocks, not 32) and kStages - 1 tiles in flight a block.  q is
// rotated in fp32 and never rounded, and at these few rows the tensor
// cores would buy nothing, so the products run on the CUDA cores in fp32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// ring stages for 16-bit and int8 pages (fp32 pages take 2), and the
// blocks an SM must hold of the many-row kernel (its register cap): the
// defaults are what tools/decode_ab.py --sweep measured best
#ifndef DECODE_STAGES
#define DECODE_STAGES 3
#endif
#ifndef DECODE_ROWS_MIN_BLOCKS
#define DECODE_ROWS_MIN_BLOCKS 2
#endif

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSq = 8;        // query rows per sequence the small kernel takes
constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;        // tokens staged at a time
constexpr int kSpanQuantum = 64; // a span is a multiple of this
constexpr int kMaxSpan = 512;

// ------------------------------------------------------------ element I/O

template <int E>
__device__ __forceinline__ void load_row(const float* p, float* out) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const float2 x = *reinterpret_cast<const float2*>(p + e);
    out[e] = x.x;
    out[e + 1] = x.y;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
    out[e] = x.x;
    out[e + 1] = x.y;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __half* p, float* out) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(p + e));
    out[e] = x.x;
    out[e + 1] = x.y;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const int8_t* p, float* out) {
  if constexpr (E == 4) {
    const char4 x = *reinterpret_cast<const char4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    static_assert(E == 2, "int8 rows of 64 or 128 dims");
    const char2 x = *reinterpret_cast<const char2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}

// four consecutive elements of a K or V row, in fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  return make_float4(x.x, x.y, x.z, x.w);
}

// n int8 values of a row times their scales (srow: the row's nb scales,
// kb: each value's scale block; one: all in block kb[0])
template <int N>
__device__ __forceinline__ void dequant(float* x, const float* srow,
                                        const int* kb, bool one) {
  if (one) {
    const float f = srow[kb[0]];
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] *= f;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] *= srow[kb[e]];
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// round to nearest even; past 65504 an fp16 output is inf, as in JAX
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --------------------------------------------------------------- cp.async

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------- the staging ring

// One stage: the K tile, the V tile (kTile rows of D elements of P each),
// then (int8 pages) the K and V scales of those rows, kTile * nb floats
// each, padded to 16 bytes.
template <typename P, int D>
struct Ring {
  static constexpr bool kInt8 = std::is_same_v<P, int8_t>;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(P));
  static constexpr int kChunks = kRowBytes / 16;     // 16-byte copies a row
  static constexpr int kStages = sizeof(P) == 4 ? 2 : DECODE_STAGES;
  static_assert(kRowBytes % 16 == 0, "rows of whole 16-byte chunks");

  __host__ __device__ static int stage_bytes(int nb) {
    return 2 * kTile * kRowBytes +
           (kInt8 ? (2 * kTile * nb * 4 + 15) / 16 * 16 : 0);
  }
};

// The pool row of each of the span's first n_tok positions, through the
// sequence's page table row: (page * h + head) * page_size + offset.
__device__ __forceinline__ void span_rows(long long* s_row, const int* prow,
                                          int sp0, int n_tok, int head,
                                          int h, int page_size) {
  for (int t = threadIdx.x; t < n_tok; t += kThreads) {
    const int pos = sp0 + t;
    s_row[t] = (static_cast<long long>(prow[pos / page_size]) * h + head) *
                   page_size +
               pos % page_size;
  }
}

// Issue the copies of the span's tokens [t0, t0 + tn) into stage `st`.
template <typename P, int D>
__device__ __forceinline__ void stage_tile(unsigned char* st,
                                           const long long* s_row, int t0,
                                           int tn, const P* k_pages,
                                           const P* v_pages,
                                           const float* k_scales,
                                           const float* v_scales, int nb) {
  using R = Ring<P, D>;
  constexpr int kPer = 16 / static_cast<int>(sizeof(P));   // elements a copy
  P* sk = reinterpret_cast<P*>(st);
  P* sv = reinterpret_cast<P*>(st + kTile * R::kRowBytes);
  for (int idx = threadIdx.x; idx < tn * R::kChunks; idx += kThreads) {
    const int t = idx / R::kChunks;
    const int c = (idx % R::kChunks) * kPer;
    const long long row = s_row[t0 + t];
    cp_async16(sk + t * D + c, k_pages + row * D + c);
    cp_async16(sv + t * D + c, v_pages + row * D + c);
  }
  if constexpr (R::kInt8) {
    float* ks = reinterpret_cast<float*>(st + 2 * kTile * R::kRowBytes);
    float* vs = ks + kTile * nb;
    for (int idx = threadIdx.x; idx < tn * nb; idx += kThreads) {
      const int t = idx / nb, e = idx % nb;
      const long long row = s_row[t0 + t];
      cp_async4(ks + idx, k_scales + row * nb + e);
      cp_async4(vs + idx, v_scales + row * nb + e);
    }
  }
}

// Walk the span's n_tok staged tokens in tiles of kTile, kStages - 1
// tiles in flight: compute(stage, t0, tn) sees tokens [t0, t0 + tn) of
// the span.  Every thread of the block calls it; on return the ring's
// shared memory is free (no copy in flight, every reader done).
template <typename P, int D, typename F>
__device__ __forceinline__ void walk_span(unsigned char* ring, int stage,
                                          const long long* s_row, int n_tok,
                                          const P* k_pages, const P* v_pages,
                                          const float* k_scales,
                                          const float* v_scales, int nb,
                                          F&& compute) {
  using R = Ring<P, D>;
  const int n_tiles = (n_tok + kTile - 1) / kTile;
#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < n_tiles)
      stage_tile<P, D>(ring + s * stage, s_row, s * kTile,
                       min(kTile, n_tok - s * kTile), k_pages, v_pages,
                       k_scales, v_scales, nb);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<R::kStages - 2>();   // this thread's copies of tile `it`
    __syncthreads();                   // everyone's; tile it-1 read
    const int nxt = it + R::kStages - 1;
    if (nxt < n_tiles)
      stage_tile<P, D>(ring + (nxt % R::kStages) * stage, s_row,
                       nxt * kTile, min(kTile, n_tok - nxt * kTile), k_pages,
                       v_pages, k_scales, v_scales, nb);
    cp_async_commit();
    compute(ring + (it % R::kStages) * stage, it * kTile,
            min(kTile, n_tok - it * kTile));
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------------------------------ the span merge

// After each thread of the block wrote its part of the block's partials:
// true in every thread of the last of the n blocks of a group to get
// here, which then sees all n groups' partials; the counter is reset for
// the next launch.
__device__ __forceinline__ bool last_of_group(int* counter, int n) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counter, 1) == n - 1;
    if (s_last) *counter = 0;   // every block of the group has its ticket
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// One warp merges one row's n_split partials, in span order; lane L
// writes dims [L * D / 32, (L + 1) * D / 32).  acc: the row's n_split x D
// accs, ml: its n_split (m, l) pairs.
template <typename T, int D>
__device__ __forceinline__ void merge_row(const float* acc, const float* ml,
                                          int n_split, T* out, int lane) {
  constexpr int E = D / 32;
  float mm = kNegInf;
  for (int j = 0; j < n_split; ++j) mm = fmaxf(mm, __ldcg(ml + 2 * j));
  float ll = 0.0f, o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.0f;
  for (int j = 0; j < n_split; ++j) {
    const float lj = __ldcg(ml + 2 * j + 1);
    if (lj > 0.0f) {           // an empty span adds exactly nothing
      const float f = expf(__ldcg(ml + 2 * j) - mm);
      ll = fmaf(lj, f, ll);
      const float* a = acc + static_cast<long long>(j) * D + lane * E;
      float x[E];
      if constexpr (E == 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(a));
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      } else {
        static_assert(E == 2, "rows of 64 or 128 dims");
        const float2 v = __ldcg(reinterpret_cast<const float2*>(a));
        x[0] = v.x; x[1] = v.y;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = fmaf(x[e], f, o[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    store(out + lane * E + e, o[e] / fmaxf(ll, 1e-30f));
}

// ------------------------------------------------------- the small kernel

// q, out: (b, h, sq, D); k_pages, v_pages: (num_pages, h, page_size, D)
// of P (T, or int8_t with k_scales/v_scales (num_pages, h, page_size, nb)
// fp32, one per kv_block dims); page_table: (b, pages_per_seq) int32;
// lengths: (b,) int32; ws_acc (b, h, sq, n_split, D) and ws_ml (b, h, sq,
// n_split, 2) fp32 and counters (b * h) int32, unused when n_split = 1.
// Grid (n_split, h, b); SQ: the rows the instance keeps (1 or kMaxSq).
template <typename T, typename P, int D, bool kRope, int SQ>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                    const P* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const float* __restrict__ rope_cos,
                    const float* __restrict__ rope_sin, T* __restrict__ out,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int* __restrict__ counters, int h, int sq, int page_size,
                    int pages_per_seq, int nb, int kv_block, int causal,
                    float scale, int span, int n_split) {
  using R = Ring<P, D>;
  constexpr int E = D / 32;    // dims per lane
  constexpr int U = kTile / kWarps;   // tokens a warp scores a tile
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_row = reinterpret_cast<long long*>(smem);
  unsigned char* ring = smem + span * sizeof(long long);

  const int j = blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[b];
  const int n_vis = max(0, min(len, pages_per_seq * page_size));
  const int sp0 = j * span;
  const int n_tok = max(0, min(span, n_vis - sp0));

  float acc[SQ][E], m[SQ], l[SQ];
#pragma unroll
  for (int i = 0; i < SQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.0f;
  }

  if (n_tok > 0) {
    // the page-table reads first: their latency overlaps q's
    span_rows(s_row, page_table + (long long)b * pages_per_seq, sp0, n_tok,
              head, h, page_size);
    float qr[SQ][E];
#pragma unroll
    for (int i = 0; i < SQ; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[i][e] = 0.0f;
      if (i >= sq) continue;
      load_row<E>(q + (((long long)b * h + head) * sq + i) * D + lane * E,
                  qr[i]);
      if constexpr (kRope) {
        // lanes 0-15 hold the first half of the row, 16-31 the second:
        // rotate_half(q) is -q[c + D/2] below D/2 and q[c - D/2] above
        const long long at = ((long long)b * sq + i) * (D / 2) +
                             (lane & 15) * E;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float other = __shfl_xor_sync(0xffffffffu, qr[i][e], 16);
          const float rot = lane < 16 ? -other : other;
          qr[i][e] = qr[i][e] * rope_cos[at + e] + rot * rope_sin[at + e];
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) qr[i][e] *= scale;
    }
    // the scale block of each of this lane's dims (int8 pages); one
    // scale for all of them when kv_block % E == 0, as for every kv_block
    // the cache uses
    int kb[E];
#pragma unroll
    for (int e = 0; e < E; ++e) kb[e] = R::kInt8 ? (lane * E + e) / kv_block : 0;
    const bool one_scale = kv_block % E == 0;
    __syncthreads();   // s_row
    const int last = len - sq;   // row i sees positions <= last + i (causal)
    walk_span<P, D>(
        ring, R::stage_bytes(nb), s_row, n_tok, k_pages, v_pages, k_scales,
        v_scales, nb, [&](const unsigned char* st, int t0, int tn) {
          const P* sk = reinterpret_cast<const P*>(st);
          const P* sv = reinterpret_cast<const P*>(st + kTile * R::kRowBytes);
          const float* sks =
              reinterpret_cast<const float*>(st + 2 * kTile * R::kRowBytes);
          const float* svs = sks + kTile * nb;
          float kf[U][E], s[SQ][U];
          bool in[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int t = u * kWarps + warp;
            in[u] = t < tn;
            // a slot past tn holds stale bytes: scored, never used
            load_row<E>(sk + t * D + lane * E, kf[u]);
            if constexpr (R::kInt8) dequant<E>(kf[u], sks + t * nb, kb, one_scale);
          }
#pragma unroll
          for (int i = 0; i < SQ; ++i)
#pragma unroll
            for (int u = 0; u < U; ++u) {
              float x = 0.0f;
#pragma unroll
              for (int e = 0; e < E; ++e) x = fmaf(qr[i][e], kf[u][e], x);
              s[i][u] = x;
            }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < SQ; ++i) {
              if (i >= sq) break;
#pragma unroll
              for (int u = 0; u < U; ++u)
                s[i][u] += __shfl_xor_sync(0xffffffffu, s[i][u], o);
            }
          float vf[U][E];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int t = u * kWarps + warp;
            load_row<E>(sv + t * D + lane * E, vf[u]);
            if constexpr (R::kInt8) dequant<E>(vf[u], svs + t * nb, kb, one_scale);
          }
#pragma unroll
          for (int i = 0; i < SQ; ++i) {
            if (i >= sq) break;
            // this tile's tokens the row may see (warp-uniform)
            bool vis[U];
            float mt = kNegInf;
            bool any = false;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int pos = sp0 + t0 + u * kWarps + warp;
              vis[u] = in[u] && (!causal || pos <= last + i);
              if (vis[u]) {
                mt = fmaxf(mt, s[i][u]);
                any = true;
              }
            }
            if (!any) continue;
            const float m_new = fmaxf(m[i], mt);
            const float corr = expf(m[i] - m_new);
            float pu[U], sum = 0.0f;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              pu[u] = vis[u] ? expf(s[i][u] - m_new) : 0.0f;
              sum += pu[u];
            }
            l[i] = fmaf(l[i], corr, sum);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              float a = acc[i][e] * corr;
#pragma unroll
              for (int u = 0; u < U; ++u)
                if (vis[u]) a = fmaf(pu[u], vf[u][e], a);
              acc[i][e] = a;
            }
            m[i] = m_new;
          }
        });
  }

  // merge the warps' states through shared memory (the ring is free)
  float* sm_m = reinterpret_cast<float*>(ring);   // [kWarps][SQ]
  float* sm_l = sm_m + kWarps * SQ;
  float* sm_acc = sm_l + kWarps * SQ;              // [kWarps][SQ][D]
#pragma unroll
  for (int i = 0; i < SQ; ++i) {
    if (i >= sq) break;
    if (lane == 0) {
      sm_m[warp * SQ + i] = m[i];
      sm_l[warp * SQ + i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      sm_acc[(warp * SQ + i) * D + lane * E + e] = acc[i][e];
  }
  __syncthreads();
  const long long row0 = ((long long)b * h + head) * sq;
  for (int idx = threadIdx.x; idx < sq * D; idx += kThreads) {
    const int i = idx / D, c = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * SQ + i]);
    float ll = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w * SQ + i] - mm);
      ll = fmaf(sm_l[w * SQ + i], f, ll);
      o = fmaf(sm_acc[(w * SQ + i) * D + c], f, o);
    }
    if (n_split == 1) {
      store(out + (row0 + i) * D + c, o / fmaxf(ll, 1e-30f));
      continue;
    }
    const long long at = (row0 + i) * n_split + j;
    if (ll > 0.0f) ws_acc[at * D + c] = o;
    if (c == 0) {
      ws_ml[2 * at] = mm;
      ws_ml[2 * at + 1] = ll;
    }
  }
  if (n_split == 1) return;
  if (!last_of_group(counters + (long long)b * h + head, n_split)) return;
  for (int i = warp; i < sq; i += kWarps)
    merge_row<T, D>(ws_acc + (row0 + i) * n_split * D,
                    ws_ml + (row0 + i) * n_split * 2, n_split,
                    out + (row0 + i) * D, lane);
}

// Set a kernel's dynamic shared memory limit once, to the most any of
// its launches can ask for.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

// the most dynamic shared memory an instance over P, D can need: the
// span's row indices, then the ring (scales of kv_block 1 at most) or the
// warps' merge, whichever is larger
template <typename P, int D>
constexpr int max_smem() {
  constexpr int ring = Ring<P, D>::kStages * (2 * kTile * D * (int)sizeof(P) +
                                              2 * kTile * D * 4);
  constexpr int merge = (2 * kWarps * kMaxSq + kWarps * kMaxSq * D) * 4;
  return kMaxSpan * 8 + (ring > merge ? ring : merge);
}

template <typename T, typename P, int D, bool kRope, int SQ>
cudaError_t launch_small(const void* q, const void* k_pages,
                         const void* v_pages, const float* k_scales,
                         const float* v_scales, const int* page_table,
                         const int* lengths, const float* rope_cos,
                         const float* rope_sin, void* out, float* ws,
                         int* counters, int b, int h, int sq, int page_size,
                         int pages_per_seq, int nb, int kv_block, int causal,
                         float scale, int span, int n_split,
                         cudaStream_t stream) {
  using R = Ring<P, D>;
  auto kernel = paged_decode_kernel<T, P, D, kRope, SQ>;
  static int allowed = 0;
  const cudaError_t e = allow_smem(kernel, max_smem<P, D>(), &allowed);
  if (e != cudaSuccess) return e;
  const int merge = (2 * kWarps * SQ + kWarps * SQ * D) * 4;
  const int ring = R::kStages * R::stage_bytes(nb);
  const int smem = span * 8 + (ring > merge ? ring : merge);
  float* ws_ml =
      ws ? ws + (long long)b * h * sq * n_split * D : nullptr;
  kernel<<<dim3(n_split, h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), k_scales, v_scales, page_table,
      lengths, rope_cos, rope_sin, static_cast<T*>(out), ws, ws_ml, counters,
      h, sq, page_size, pages_per_seq, nb, kv_block, causal, scale, span,
      n_split);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int* page_table, const int* lengths,
                   const float* rope_cos, const float* rope_sin, void* out,
                   float* ws, int* counters, int b, int h, int sq,
                   int page_size, int pages_per_seq, int nb, int kv_block,
                   int causal, float scale, int span, int n_split,
                   cudaStream_t stream) {
#define SMALL(ROPE, SQ)                                                     \
  return launch_small<T, P, D, ROPE, SQ>(                                   \
      q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,         \
      rope_cos, rope_sin, out, ws, counters, b, h, sq, page_size,           \
      pages_per_seq, nb, kv_block, causal, scale, span, n_split, stream)
  if (rope_cos != nullptr) {
    if (sq == 1) SMALL(true, 1);
    SMALL(true, kMaxSq);
  }
  if (sq == 1) SMALL(false, 1);
  SMALL(false, kMaxSq);
#undef SMALL
}

// ------------------------------------------------------ the many-row kernel

constexpr int kRowsPerWarp = 8;                 // query rows a warp owns
constexpr int kTokens = 4;                      // tokens scored together
constexpr int kMaxRows = 512;
constexpr int kMaxTreeRows = 31;

// one row's visibility over the fresh rows of a tree verify, bit j set
// iff the row attends fresh row j; passed to the kernel by value
struct TreeBits {
  int bits[kMaxTreeRows];
};

// q, out: (b, h, sq, D); pages, scales, workspace as paged_decode_kernel
// (counters: b * h * tiles); row_tile = 8 * row_groups query rows a
// block, row_groups in {1, 2, 4, 8}; the grid is (n_split * tiles, h, b)
// with tiles = ceil(sq / row_tile), blockIdx.x = span + n_split * tile.
// causal masks each row at its position; tree_rows > 0 (== sq) masks the
// fresh rows by tree instead.
//
// Layout: the 8 warps are row_groups groups of rows times 8 / row_groups
// groups of tokens.  Warp w owns rows r0 + (w % RG) + RG * j (j < 8) of
// the tile and the tile's 4-token groups g with g % TG == w / RG; a
// narrow tile (a tree verify's 9 rows, a 16-row chunk) so spreads the
// tokens over the warps instead of leaving most of them idle.  A warp
// works on 4 of its rows at once, one per quarter of its lanes; the 8
// lanes of a quarter split the row's D dims in 4-element chunks, lane
// `sub` taking chunks sub, sub + 8, ... (D / 8 dims), so a row's score
// needs 3 shuffles inside the quarter and one shuffle instruction serves
// 4 rows.  The 4 quarters read the same staged token (a broadcast), and
// the dims a rotation pairs (c and c + D/2) sit in the same lane.  At the
// span's end the token groups' states of a row merge through shared
// memory in token-group order.
template <typename T, typename P, int D, bool kRope>
__global__ void __launch_bounds__(kThreads, DECODE_ROWS_MIN_BLOCKS)
paged_decode_rows_kernel(const T* __restrict__ q,
                         const P* __restrict__ k_pages,
                         const P* __restrict__ v_pages,
                         const float* __restrict__ k_scales,
                         const float* __restrict__ v_scales,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths,
                         const float* __restrict__ rope_cos,
                         const float* __restrict__ rope_sin,
                         T* __restrict__ out, float* __restrict__ ws_acc,
                         float* __restrict__ ws_ml,
                         int* __restrict__ counters, int h, int sq,
                         int page_size, int pages_per_seq, int nb,
                         int kv_block, int causal, int tree_rows,
                         TreeBits tree, float scale, int span, int n_split,
                         int row_groups) {
  using R = Ring<P, D>;
  constexpr int kLanesPerRow = 8;
  constexpr int kGroups = 32 / kLanesPerRow;      // rows a warp works at once
  constexpr int kPasses = kRowsPerWarp / kGroups;
  constexpr int ED = D / kLanesPerRow;            // dims per lane
  constexpr int NC = ED / 4;                      // 4-element chunks per lane
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_row = reinterpret_cast<long long*>(smem);
  unsigned char* ring = smem + span * sizeof(long long);

  const int RG = row_groups, TG = kWarps / row_groups;
  const int tile_rows = kRowsPerWarp * RG;
  const int j = blockIdx.x % n_split;
  const int tile = blockIdx.x / n_split;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = tile * tile_rows;
  const int r1 = min(sq, r0 + tile_rows);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp % RG, tg = warp / RG;
  const int grp = lane / kLanesPerRow;
  const int sub = lane % kLanesPerRow;
  const int len = lengths[b];
  const int base = len - sq;   // the position of query row 0

  // the positions this tile may see: causal stops at its last row's
  // position; a tree verify (and a non-causal call) sees the whole length
  int n_vis = (causal && tree_rows == 0) ? min(len, base + r1) : len;
  n_vis = max(0, min(n_vis, pages_per_seq * page_size));
  const int sp0 = j * span;
  const int n_tok = max(0, min(span, n_vis - sp0));

  // qr[p][4k + e] and acc[p][4k + e] hold dim 4 * (sub + 8k) + e
  float qr[kPasses][ED], acc[kPasses][ED], m[kPasses], l[kPasses];
  int row[kPasses], mask_bits[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    row[p] = r0 + rg + RG * (p * kGroups + grp);
    m[p] = kNegInf;
    l[p] = 0.0f;
#pragma unroll
    for (int e = 0; e < ED; ++e) acc[p][e] = 0.0f;
  }

  if (n_tok > 0) {
    // the page-table reads first: their latency overlaps q's
    span_rows(s_row, page_table + (long long)b * pages_per_seq, sp0, n_tok,
              head, h, page_size);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const bool live = row[p] < r1;
      mask_bits[p] = live && tree_rows > 0 ? tree.bits[row[p]] : 0;
#pragma unroll
      for (int e = 0; e < ED; ++e) qr[p][e] = 0.0f;
      if (!live) continue;
      const T* qrow = q + (((long long)b * h + head) * sq + row[p]) * D;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float4 x = load4(qrow + 4 * (sub + kLanesPerRow * k));
        qr[p][4 * k] = x.x; qr[p][4 * k + 1] = x.y;
        qr[p][4 * k + 2] = x.z; qr[p][4 * k + 3] = x.w;
      }
      if constexpr (kRope) {
        // chunk k (< NC / 2) holds dims c of the first half, chunk k + NC / 2
        // their partners c + D/2: q * cos + rotate_half(q) * sin in fp32
        const long long at = ((long long)b * sq + row[p]) * (D / 2);
#pragma unroll
        for (int k = 0; k < NC / 2; ++k) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * (sub + kLanesPerRow * k) + e;
            const float cs = rope_cos[at + c], sn = rope_sin[at + c];
            const float x1 = qr[p][4 * k + e];
            const float x2 = qr[p][4 * (k + NC / 2) + e];
            qr[p][4 * k + e] = x1 * cs + (-x2) * sn;
            qr[p][4 * (k + NC / 2) + e] = x2 * cs + x1 * sn;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < ED; ++e) qr[p][e] *= scale;
    }
    // passes with a row of this warp in them (warp-uniform)
    const int n_pass = r0 + rg >= r1 ? 0
                       : r0 + rg + RG * kGroups < r1 ? kPasses : 1;
    // the scale block of each of this lane's 4-element chunks (int8
    // pages; kv_block % 4 == 0, as for every kv_block the cache uses),
    // or of each element
    int kb[ED];
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        kb[4 * k + e] =
            R::kInt8 ? (4 * (sub + kLanesPerRow * k) + e) / kv_block : 0;
    const bool chunk_scale = kv_block % 4 == 0;
    __syncthreads();   // s_row
    walk_span<P, D>(
        ring, R::stage_bytes(nb), s_row, n_tok, k_pages, v_pages, k_scales,
        v_scales, nb, [&](const unsigned char* st, int t0, int tn) {
          if (n_pass == 0) return;
          const P* sk = reinterpret_cast<const P*>(st);
          const P* sv = reinterpret_cast<const P*>(st + kTile * R::kRowBytes);
          const float* sks =
              reinterpret_cast<const float*>(st + 2 * kTile * R::kRowBytes);
          const float* svs = sks + kTile * nb;
          // a token's 4-element chunks of this lane, in fp32 (int8:
          // times their scales)
          auto row_of = [&](const P* tile_base, const float* scales, int t,
                            float* x) {
#pragma unroll
            for (int k = 0; k < NC; ++k) {
              const float4 v =
                  load4(tile_base + t * D + 4 * (sub + kLanesPerRow * k));
              x[4 * k] = v.x; x[4 * k + 1] = v.y;
              x[4 * k + 2] = v.z; x[4 * k + 3] = v.w;
              if constexpr (R::kInt8) {
                if (chunk_scale) {
                  const float f = scales[t * nb + kb[4 * k]];
#pragma unroll
                  for (int e = 0; e < 4; ++e) x[4 * k + e] *= f;
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    x[4 * k + e] *= scales[t * nb + kb[4 * k + e]];
                }
              }
            }
          };
          for (int t = kTokens * tg; t < tn; t += kTokens * TG) {
            // the scores of kTokens tokens first (independent products and
            // shuffles, whose latencies overlap), then each row's updates
            // in position order; a token slot past tn reads staged bytes
            // that are never used
            float sc[kPasses][kTokens];
#pragma unroll
            for (int u = 0; u < kTokens; ++u) {
              float kv[ED];
              row_of(sk, sks, t + u, kv);
#pragma unroll
              for (int p = 0; p < kPasses; ++p) {
                sc[p][u] = 0.0f;
                if (p >= n_pass) break;
#pragma unroll
                for (int e = 0; e < ED; ++e)
                  sc[p][u] = fmaf(qr[p][e], kv[e], sc[p][u]);
              }
            }
#pragma unroll
            for (int o = 4; o > 0; o >>= 1)
#pragma unroll
              for (int p = 0; p < kPasses; ++p) {
                if (p >= n_pass) break;
#pragma unroll
                for (int u = 0; u < kTokens; ++u)
                  sc[p][u] += __shfl_xor_sync(0xffffffffu, sc[p][u], o);
              }
#pragma unroll
            for (int u = 0; u < kTokens; ++u) {
              if (t + u >= tn) break;
              const int pos = sp0 + t0 + t + u;
              float vv[ED];
              row_of(sv, svs, t + u, vv);
#pragma unroll
              for (int p = 0; p < kPasses; ++p) {
                if (p >= n_pass) break;
                // this token's visibility to the quarter's row: a score the
                // row may not see (even NaN from the null page) is never
                // used
                bool vis = row[p] < r1;
                if (tree_rows > 0) {
                  const int fresh = pos - base;
                  vis = vis && (fresh < 0 || ((mask_bits[p] >> fresh) & 1));
                } else if (causal) {
                  vis = vis && pos <= base + row[p];
                }
                if (!vis) continue;
                const float s = sc[p][u];
                if (s > m[p]) {
                  const float corr = expf(m[p] - s);
                  m[p] = s;
                  l[p] = fmaf(l[p], corr, 1.0f);
#pragma unroll
                  for (int e = 0; e < ED; ++e)
                    acc[p][e] = fmaf(acc[p][e], corr, vv[e]);
                } else {
                  const float pe = expf(s - m[p]);
                  l[p] += pe;
#pragma unroll
                  for (int e = 0; e < ED; ++e)
                    acc[p][e] = fmaf(pe, vv[e], acc[p][e]);
                }
              }
            }
          }
        });
  }

  // merge the token groups' states of each row through shared memory (the
  // ring is free), in token-group order: slot tg * tile_rows + (row - r0)
  float* sm_ml = reinterpret_cast<float*>(ring);   // [kWarps * 8][2]
  float* sm_acc = sm_ml + 2 * kWarps * kRowsPerWarp;   // [kWarps * 8][D]
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (row[p] >= r1) continue;
    const int slot = tg * tile_rows + row[p] - r0;
    if (sub == 0) {
      sm_ml[2 * slot] = m[p];
      sm_ml[2 * slot + 1] = l[p];
    }
#pragma unroll
    for (int k = 0; k < NC; ++k)
      *reinterpret_cast<float4*>(sm_acc + slot * D +
                                 4 * (sub + kLanesPerRow * k)) =
          make_float4(acc[p][4 * k], acc[p][4 * k + 1], acc[p][4 * k + 2],
                      acc[p][4 * k + 3]);
  }
  __syncthreads();
  // one span: O directly; else the row's partial, and the last block of
  // the (sequence, head, tile) merges
  const long long row0 = ((long long)b * h + head) * sq;
  for (int idx = threadIdx.x; idx < (r1 - r0) * D; idx += kThreads) {
    const int rr = idx / D, c = idx % D;
    float mm = kNegInf;
    for (int g = 0; g < TG; ++g)
      mm = fmaxf(mm, sm_ml[2 * (g * tile_rows + rr)]);
    float ll = 0.0f, o = 0.0f;
    for (int g = 0; g < TG; ++g) {
      const int slot = g * tile_rows + rr;
      const float f = expf(sm_ml[2 * slot] - mm);
      ll = fmaf(sm_ml[2 * slot + 1], f, ll);
      o = fmaf(sm_acc[slot * D + c], f, o);
    }
    if (n_split == 1) {
      store(out + (row0 + r0 + rr) * D + c, o / fmaxf(ll, 1e-30f));
      continue;
    }
    const long long at = (row0 + r0 + rr) * n_split + j;
    if (ll > 0.0f) ws_acc[at * D + c] = o;
    if (c == 0) {
      ws_ml[2 * at] = mm;
      ws_ml[2 * at + 1] = ll;
    }
  }
  if (n_split == 1) return;
  const int tiles = gridDim.x / n_split;
  if (!last_of_group(counters + ((long long)b * h + head) * tiles + tile,
                     n_split))
    return;
  for (int r = r0 + warp; r < r1; r += kWarps)
    merge_row<T, D>(ws_acc + (row0 + r) * n_split * D,
                    ws_ml + (row0 + r) * n_split * 2, n_split,
                    out + (row0 + r) * D, lane);
}

template <typename T, typename P, int D, bool kRope>
cudaError_t launch_rows_as(const void* q, const void* k_pages,
                           const void* v_pages, const float* k_scales,
                           const float* v_scales, const int* page_table,
                           const int* lengths, const float* rope_cos,
                           const float* rope_sin, const TreeBits& tree,
                           void* out, float* ws, int* counters, int b, int h,
                           int sq, int page_size, int pages_per_seq, int nb,
                           int kv_block, int causal, int tree_rows,
                           float scale, int span, int n_split, int row_tile,
                           cudaStream_t stream) {
  using R = Ring<P, D>;
  auto kernel = paged_decode_rows_kernel<T, P, D, kRope>;
  static int allowed = 0;
  const cudaError_t e = allow_smem(kernel, max_smem<P, D>(), &allowed);
  if (e != cudaSuccess) return e;
  const int ring = R::kStages * R::stage_bytes(nb);
  const int merge = kWarps * kRowsPerWarp * (D + 2) * 4;
  const int smem = span * 8 + (ring > merge ? ring : merge);
  const int tiles = (sq + row_tile - 1) / row_tile;
  float* ws_ml =
      ws ? ws + (long long)b * h * sq * n_split * D : nullptr;
  kernel<<<dim3(n_split * tiles, h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), k_scales, v_scales, page_table,
      lengths, rope_cos, rope_sin, static_cast<T*>(out), ws, ws_ml, counters,
      h, sq, page_size, pages_per_seq, nb, kv_block, causal, tree_rows, tree,
      scale, span, n_split, row_tile / kRowsPerWarp);
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch_rows(const void* q, const void* k_pages,
                        const void* v_pages, const float* k_scales,
                        const float* v_scales, const int* page_table,
                        const int* lengths, const float* rope_cos,
                        const float* rope_sin, const TreeBits& tree,
                        void* out, float* ws, int* counters, int b, int h,
                        int sq, int page_size, int pages_per_seq, int nb,
                        int kv_block, int causal, int tree_rows, float scale,
                        int span, int n_split, int row_tile,
                        cudaStream_t stream) {
  auto go = rope_cos != nullptr ? launch_rows_as<T, P, D, true>
                                : launch_rows_as<T, P, D, false>;
  return go(q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
            rope_cos, rope_sin, tree, out, ws, counters, b, h, sq, page_size,
            pages_per_seq, nb, kv_block, causal, tree_rows, scale, span,
            n_split, row_tile, stream);
}

// the spans a pool row of pages_per_seq * page_size positions splits into
long long span_count(int page_size, int pages_per_seq, int span) {
  return ((long long)page_size * pages_per_seq + span - 1) / span;
}

bool bad_split(int page_size, int pages_per_seq, int span, int n_split,
               const float* ws, const int* counters) {
  return span < kSpanQuantum || span > kMaxSpan || span % kSpanQuantum ||
         n_split != span_count(page_size, pages_per_seq, span) ||
         (n_split > 1 && (ws == nullptr || counters == nullptr));
}

bool bad_shape(int b, int h, int sq, int page_size, int pages_per_seq,
               const float* rope_cos, const float* rope_sin) {
  return b <= 0 || b > 65535 || h <= 0 || h > 65535 || sq < 1 ||
         sq > kMaxSq || page_size < 1 || pages_per_seq < 1 ||
         (long long)page_size * pages_per_seq > (1LL << 30) ||
         (rope_cos == nullptr) != (rope_sin == nullptr);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (this source), 2 = fp16 (the build with
// DECODE_F16 defined, attention_decode_f16.cu, which holds only those);
// rope_cos/rope_sin: (b, sq, d/2) fp32, or
// both null for no rotation.  span: positions a block takes (a multiple
// of 64, at most 512); n_split = ceil(pages_per_seq * page_size / span);
// ws: (b * h * sq * n_split * (d + 2)) fp32 and counters (b * h) int32,
// zero and left zero, both unused (may be null) when n_split = 1.
// Returns a cudaError_t code (0 = success).
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const int* page_table, const int* lengths,
                 const float* rope_cos, const float* rope_sin, void* out,
                 float* ws, int* counters, int b, int h, int sq, int d,
                 int page_size, int pages_per_seq, int dtype, int causal,
                 int span, int n_split, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, h, sq, page_size, pages_per_seq, rope_cos, rope_sin) ||
      bad_split(page_size, pages_per_seq, span, n_split, ws, counters))
    return cudaErrorInvalidValue;
#define DECODE(T, D)                                                       \
  return launch<T, T, D>(q, k_pages, v_pages, nullptr, nullptr, page_table, \
                         lengths, rope_cos, rope_sin, out, ws, counters, b, \
                         h, sq, page_size, pages_per_seq, 0, 1, causal,     \
                         scale, span, n_split, s)
#if defined(DECODE_F16)
  if (dtype == 2 && d == 128) DECODE(__half, 128);
  if (dtype == 2 && d == 64) DECODE(__half, 64);
#else
  if (dtype == 0 && d == 128) DECODE(float, 128);
  if (dtype == 0 && d == 64) DECODE(float, 64);
  if (dtype == 1 && d == 128) DECODE(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) DECODE(__nv_bfloat16, 64);
#endif
#undef DECODE
  return cudaErrorInvalidValue;
}

// int8 pages: k_pages/v_pages int8, k_scales/v_scales (num_pages, h,
// page_size, nb) fp32 with nb = ceil(d / kv_block); q and out in dtype
// (0 = fp32, 1 = bf16, 2 = fp16, as paged_decode).  Otherwise as paged_decode.
int paged_decode_int8(const void* q, const void* k_pages, const void* v_pages,
                      const float* k_scales, const float* v_scales,
                      const int* page_table, const int* lengths,
                      const float* rope_cos, const float* rope_sin, void* out,
                      float* ws, int* counters, int b, int h, int sq, int d,
                      int page_size, int pages_per_seq, int nb, int kv_block,
                      int dtype, int causal, int span, int n_split,
                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, h, sq, page_size, pages_per_seq, rope_cos, rope_sin) ||
      bad_split(page_size, pages_per_seq, span, n_split, ws, counters) ||
      kv_block < 1 || nb != (d + kv_block - 1) / kv_block ||
      k_scales == nullptr || v_scales == nullptr)
    return cudaErrorInvalidValue;
#define DECODE(T, D)                                                       \
  return launch<T, int8_t, D>(q, k_pages, v_pages, k_scales, v_scales,     \
                              page_table, lengths, rope_cos, rope_sin, out, \
                              ws, counters, b, h, sq, page_size,            \
                              pages_per_seq, nb, kv_block, causal, scale,   \
                              span, n_split, s)
#if defined(DECODE_F16)
  if (dtype == 2 && d == 128) DECODE(__half, 128);
  if (dtype == 2 && d == 64) DECODE(__half, 64);
#else
  if (dtype == 0 && d == 128) DECODE(float, 128);
  if (dtype == 0 && d == 64) DECODE(float, 64);
  if (dtype == 1 && d == 128) DECODE(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) DECODE(__nv_bfloat16, 64);
#endif
#undef DECODE
  return cudaErrorInvalidValue;
}

// The many-row instance: 1 <= sq <= 512 query rows, pages of dtype
// (page_int8 = 0) or int8 with k_scales/v_scales (page_int8 = 1, nb =
// ceil(d / kv_block)).  tree_rows = sq (<= 31) applies the ancestor mask
// whose row bitmasks tree_bits (host memory, tree_rows ints) holds;
// tree_rows = 0 masks by causal.  row_tile: query rows a block takes, 8,
// 16, 32 or 64; counters: b * h * ceil(sq / row_tile) int32.  Otherwise
// as paged_decode.
int paged_decode_rows(const void* q, const void* k_pages, const void* v_pages,
                      const float* k_scales, const float* v_scales,
                      const int* page_table, const int* lengths,
                      const float* rope_cos, const float* rope_sin,
                      const int* tree_bits, void* out, float* ws,
                      int* counters, int b, int h, int sq, int d,
                      int page_size, int pages_per_seq, int nb, int kv_block,
                      int dtype, int page_int8, int causal, int tree_rows,
                      int span, int n_split, int row_tile, float scale,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || b > 65535 || h <= 0 || h > 65535 || sq < 1 ||
      sq > kMaxRows || page_size < 1 || pages_per_seq < 1 ||
      (long long)page_size * pages_per_seq > (1LL << 30) ||
      bad_split(page_size, pages_per_seq, span, n_split, ws, counters) ||
      (row_tile != 8 && row_tile != 16 && row_tile != 32 && row_tile != 64) ||
      (rope_cos == nullptr) != (rope_sin == nullptr) || tree_rows < 0 ||
      (tree_rows > 0 && (tree_rows != sq || sq > kMaxTreeRows ||
                         tree_bits == nullptr || !causal)) ||
      (page_int8 && (kv_block < 1 || nb != (d + kv_block - 1) / kv_block ||
                     k_scales == nullptr || v_scales == nullptr)))
    return cudaErrorInvalidValue;
  TreeBits tree{};
  for (int i = 0; i < tree_rows; ++i) tree.bits[i] = tree_bits[i];
#define ROWS(T, P, D)                                                       \
  return launch_rows<T, P, D>(q, k_pages, v_pages, k_scales, v_scales,     \
                              page_table, lengths, rope_cos, rope_sin,     \
                              tree, out, ws, counters, b, h, sq,           \
                              page_size, pages_per_seq, nb, kv_block,      \
                              causal, tree_rows, scale, span, n_split,     \
                              row_tile, s)
#if defined(DECODE_F16)
  if (!page_int8) {
    if (dtype == 2 && d == 128) ROWS(__half, __half, 128);
    if (dtype == 2 && d == 64) ROWS(__half, __half, 64);
  } else {
    if (dtype == 2 && d == 128) ROWS(__half, int8_t, 128);
    if (dtype == 2 && d == 64) ROWS(__half, int8_t, 64);
  }
#else
  if (!page_int8) {
    if (dtype == 0 && d == 128) ROWS(float, float, 128);
    if (dtype == 0 && d == 64) ROWS(float, float, 64);
    if (dtype == 1 && d == 128) ROWS(__nv_bfloat16, __nv_bfloat16, 128);
    if (dtype == 1 && d == 64) ROWS(__nv_bfloat16, __nv_bfloat16, 64);
  } else {
    if (dtype == 0 && d == 128) ROWS(float, int8_t, 128);
    if (dtype == 0 && d == 64) ROWS(float, int8_t, 64);
    if (dtype == 1 && d == 128) ROWS(__nv_bfloat16, int8_t, 128);
    if (dtype == 1 && d == 64) ROWS(__nv_bfloat16, int8_t, 64);
  }
#endif
#undef ROWS
  return cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
