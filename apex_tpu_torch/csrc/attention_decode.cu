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
//    table reaches the DMA engine through scalar prefetch.  Here one
//    block owns one (sequence, head) pair and loops over the logical
//    pages itself, reading its own page_table row: nothing has to carry
//    across blocks.
//  - The block's 8 warps split the tokens of each page (warp w takes
//    tokens w, w + 8, ...) and each keeps its own online-softmax state
//    (m, l, acc) per query row, in registers; a lane holds D / 32
//    consecutive dims of q, of the current K/V row and of acc, so a K or
//    V row is read by one warp as one coalesced 2*D (bf16) or 4*D (fp32)
//    byte line.  At the end the warps' states are merged through shared
//    memory (rescale by exp(m_w - M), sum) and the block writes O.
//  - Pages at or past lengths[b] are not visited, the tail page stops at
//    lengths[b], and a position a row may not see (causal) is skipped:
//    masked probabilities are exactly zero because masked K/V are never
//    read.  So garbage on the null page 0 (idle slots write there), even
//    NaN, cannot reach a live row through 0 * NaN.
//  - The running max starts at the finite fill -1e30 (the JAX kernel's
//    _NEG_INF) and the final divide clamps l at 1e-30, so an idle slot
//    (length 0) sees no token and writes a finite zero row.
//  - The fused q-RoPE (rope_cos/rope_sin non-null, (b, sq, D/2) fp32):
//    each query row is rotated in fp32, q * cos + rotate_half(q) * sin,
//    then scaled, as the TPU body does (attention_decode.py:243-249), and
//    never rounded to q's dtype.  The TPU wrapper ships rotate_half(q) as
//    a companion operand; here lane L holds dims [L*E, L*E + E) of the
//    row, so the other half of its dims sits in lane L ^ 16 and one
//    shuffle brings it: no companion tensor is read.  K was rotated once
//    when it was written to the cache.  The rotation is a template
//    parameter: the instance without it has no rotation code, so the
//    learned-position models' decode is what it was before the rotation.
//  - int8 pages (the TPU body's has_scales branch, :254-258): K and V
//    are int8 with one fp32 scale per (page, head, token, kv_block of
//    dims), (num_pages, h, page_size, nb).  A lane reads its D / 32
//    bytes of a row and the scales of their blocks and dequantizes them
//    in fp32 before the products, as the TPU body does.  The page type
//    is a template parameter too: the fp32 and bf16 instances have no
//    dequantization code.  Entry point paged_decode_int8.
//
// What bounds it on the card: every K/V byte it reads is used for 2
// flops per query row (~1 flop per byte at sq = 1 in bf16), so it is
// bound by the bytes of the valid K/V rows.  With one block per (b, h)
// a 4-slot batch of 8 heads launches 32 blocks, a quarter of the 132 SMs:
// this first kernel cannot reach the card's memory rate at that batch;
// splitting the page walk across blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSq = 8;        // query rows per sequence this kernel takes
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, out: (b, h, sq, D); k_pages, v_pages: (num_pages, h, page_size, D)
// of P (T, or int8_t with k_scales/v_scales (num_pages, h, page_size, nb)
// fp32, one per kv_block dims); page_table: (b, pages_per_seq) int32;
// lengths: (b,) int32.
template <typename T, typename P, int D, bool kRope>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                    const P* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const float* __restrict__ rope_cos,
                    const float* __restrict__ rope_sin, T* __restrict__ out,
                    int h, int sq, int page_size, int pages_per_seq, int nb,
                    int kv_block, int causal, float scale) {
  constexpr bool kInt8 = std::is_same_v<P, int8_t>;
  constexpr int E = D / 32;    // dims per lane
  __shared__ float sm_m[kWarps][kMaxSq];
  __shared__ float sm_l[kWarps][kMaxSq];
  __shared__ float sm_acc[kWarps][kMaxSq][D];

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[b];

  float qr[kMaxSq][E], acc[kMaxSq][E], m[kMaxSq], l[kMaxSq];
#pragma unroll
  for (int i = 0; i < kMaxSq; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[i][e] = 0.0f;
      acc[i][e] = 0.0f;
    }
    if (i < sq) {
      load_row<E>(q + (((long)b * h + head) * sq + i) * D + lane * E, qr[i]);
      if constexpr (kRope) {
        // lanes 0-15 hold the first half of the row, 16-31 the second:
        // rotate_half(q) is -q[c + D/2] below D/2 and q[c - D/2] above
        const long at = ((long)b * sq + i) * (D / 2) + (lane & 15) * E;
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
  }

  const int n_pages = min(pages_per_seq, (len + page_size - 1) / page_size);
  const int* row = page_table + (long)b * pages_per_seq;
  for (int p = 0; p < n_pages; ++p) {
    const long base = ((long)row[p] * h + head) * page_size * D;
    for (int t = warp; t < page_size; t += kWarps) {
      const int pos = p * page_size + t;
      if (pos >= len) break;       // the tail page ends at len
      float kv[E], vv[E];
      load_row<E>(k_pages + base + (long)t * D + lane * E, kv);
      load_row<E>(v_pages + base + (long)t * D + lane * E, vv);
      if constexpr (kInt8) {
        const long srow = ((long)row[p] * h + head) * page_size * nb +
                          (long)t * nb;
        const int blk = lane * E / kv_block;
        if ((lane * E + E - 1) / kv_block == blk) {
          // the lane's dims lie in one scale block (kv_block % E == 0,
          // as for every kv_block the cache uses): one scale each
          const float ks = k_scales[srow + blk], vs = v_scales[srow + blk];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kv[e] *= ks;
            vv[e] *= vs;
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kv[e] *= k_scales[srow + (lane * E + e) / kv_block];
            vv[e] *= v_scales[srow + (lane * E + e) / kv_block];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxSq; ++i) {
        if (i >= sq) break;
        if (causal && pos > len - sq + i) continue;   // warp-uniform
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[i][e], kv[e], s);
        s = warp_sum(s);
        const float m_new = fmaxf(m[i], s);
        const float corr = expf(m[i] - m_new);
        const float pexp = expf(s - m_new);
        l[i] = l[i] * corr + pexp;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(acc[i][e], corr, pexp * vv[e]);
        m[i] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int i = 0; i < kMaxSq; ++i) {
    if (i >= sq) break;
    if (lane == 0) {
      sm_m[warp][i] = m[i];
      sm_l[warp][i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][i][lane * E + e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < sq * D; idx += kThreads) {
    const int i = idx / D, c = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][i]);
    float ll = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][i] - mm);
      ll = fmaf(sm_l[w][i], f, ll);
      o = fmaf(sm_acc[w][i][c], f, o);
    }
    store(out + (((long)b * h + head) * sq + i) * D + c, o / fmaxf(ll, 1e-30f));
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int* page_table, const int* lengths,
                   const float* rope_cos, const float* rope_sin, void* out,
                   int b, int h, int sq, int page_size, int pages_per_seq,
                   int nb, int kv_block, int causal, float scale,
                   cudaStream_t stream) {
  dim3 grid(h, b);
  auto kernel = rope_cos != nullptr ? paged_decode_kernel<T, P, D, true>
                                    : paged_decode_kernel<T, P, D, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), k_scales, v_scales, page_table,
      lengths, rope_cos, rope_sin, static_cast<T*>(out), h, sq, page_size,
      pages_per_seq, nb, kv_block, causal, scale);
  return cudaGetLastError();
}

bool bad_shape(int b, int h, int sq, int page_size, int pages_per_seq,
               const float* rope_cos, const float* rope_sin) {
  return b <= 0 || b > 65535 || h <= 0 || sq < 1 || sq > kMaxSq ||
         page_size < 1 || pages_per_seq < 1 ||
         (rope_cos == nullptr) != (rope_sin == nullptr);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16; rope_cos/rope_sin: (b, sq, d/2) fp32, or
// both null for no rotation.  Returns a cudaError_t code (0 = success).
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const int* page_table, const int* lengths,
                 const float* rope_cos, const float* rope_sin, void* out,
                 int b, int h, int sq, int d, int page_size,
                 int pages_per_seq, int dtype, int causal, float scale,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, h, sq, page_size, pages_per_seq, rope_cos, rope_sin))
    return cudaErrorInvalidValue;
#define DECODE(T, D)                                                       \
  return launch<T, T, D>(q, k_pages, v_pages, nullptr, nullptr, page_table, \
                         lengths, rope_cos, rope_sin, out, b, h, sq,        \
                         page_size, pages_per_seq, 0, 1, causal, scale, s)
  if (dtype == 0 && d == 128) DECODE(float, 128);
  if (dtype == 0 && d == 64) DECODE(float, 64);
  if (dtype == 1 && d == 128) DECODE(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) DECODE(__nv_bfloat16, 64);
#undef DECODE
  return cudaErrorInvalidValue;
}

// int8 pages: k_pages/v_pages int8, k_scales/v_scales (num_pages, h,
// page_size, nb) fp32 with nb = ceil(d / kv_block); q and out in dtype
// (0 = fp32, 1 = bf16).  Otherwise as paged_decode.
int paged_decode_int8(const void* q, const void* k_pages, const void* v_pages,
                      const float* k_scales, const float* v_scales,
                      const int* page_table, const int* lengths,
                      const float* rope_cos, const float* rope_sin, void* out,
                      int b, int h, int sq, int d, int page_size,
                      int pages_per_seq, int nb, int kv_block, int dtype,
                      int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, h, sq, page_size, pages_per_seq, rope_cos, rope_sin) ||
      kv_block < 1 || nb != (d + kv_block - 1) / kv_block ||
      k_scales == nullptr || v_scales == nullptr)
    return cudaErrorInvalidValue;
#define DECODE(T, D)                                                       \
  return launch<T, int8_t, D>(q, k_pages, v_pages, k_scales, v_scales,     \
                              page_table, lengths, rope_cos, rope_sin, out, \
                              b, h, sq, page_size, pages_per_seq, nb,       \
                              kv_block, causal, scale, s)
  if (dtype == 0 && d == 128) DECODE(float, 128);
  if (dtype == 0 && d == 64) DECODE(float, 64);
  if (dtype == 1 && d == 128) DECODE(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) DECODE(__nv_bfloat16, 64);
#undef DECODE
  return cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
