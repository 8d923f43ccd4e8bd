// Device helpers of the attention kernels for Hopper (sm_90a): tile
// constants, fp32/bf16/fp16 conversions, warp reductions, the per-warp fp32
// products of the SIMT kernels (full fp32 FMAs; the bf16 kernels run wgmma
// in attention_fwd_sm90.cuh and attention_bwd_sm90.cuh), tile loads and
// the dynamic shared-memory opt-in.  attention_common.cuh (the short and
// mid rungs) and attention_flash.cu (the flash rung) build their kernels
// from them.
//
// Everything has internal linkage: several loaded libraries include this
// header, and a template's static (the shared-memory opt-in flag) must not
// be unified across them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {
namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kTile = 64;       // rows of a block's q or k tile
constexpr int kWarps = 4;       // each warp owns 16 rows of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ f16 from_f<f16>(float x) {
  return __float2half_rn(x);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ warp products
// Each works on one warp's 16 rows: A and C point at the warp's first row.
//   abT: C[16 x N]  = A[16 x D] . B[N x D]^T   (overwrites C)
//   ab:  C[16 x D] += A[16 x N] . B[N x D]     (accumulates into C)
// C is fp32 in shared memory.  Lane owns columns lane + 32 * j, so abT's B
// needs an odd leading dim (32 lanes read 32 rows at one column: 32 banks).

template <int N, int D>
__device__ __forceinline__ void abT_fp32(const float* A, int lda, const float* B, int ldb,
                         float* C, int ldc, int lane) {
  constexpr int J = N / 32;
  float acc[kRows][J];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[r][j] = 0.0f;
  for (int k = 0; k < D; ++k) {
    float b[J];
#pragma unroll
    for (int j = 0; j < J; ++j) b[j] = B[(lane + 32 * j) * ldb + k];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = A[r * lda + k];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[r][j] = fmaf(a, b[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j) C[r * ldc + lane + 32 * j] = acc[r][j];
}

template <int N, int D>
__device__ __forceinline__ void ab_fp32(const float* A, int lda, const float* B, int ldb,
                        float* C, int ldc, int lane) {
  for (int r = 0; r < kRows; ++r) {
    const float* a = A + r * lda;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int col = lane + 32 * i;
      float acc = C[r * ldc + col];
      for (int j = 0; j < N; ++j) acc = fmaf(a[j], B[j * ldb + col], acc);
      C[r * ldc + col] = acc;
    }
  }
}

// Load rows [r0, r0 + rows) of a (n, D) matrix into shared memory with
// leading dim ld; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int r0, int rows, int n) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r0 + r < n) ? src[(long)(r0 + r) * D + c]
                                   : from_f<T>(0.0f);
  }
}

// The same rows of two (n, D) matrices in one loop (K and V, Q and dO):
// each thread has two loads in flight per element instead of one.
template <typename T, int D>
__device__ __forceinline__ void load_tiles(T* dst_a, int lda, T* dst_b,
                                           int ldb, const T* src_a,
                                           const T* src_b, int r0, int rows,
                                           int n) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = r0 + r < n;
    const long at = (long)(r0 + r) * D + c;
    dst_a[r * lda + c] = in ? src_a[at] : from_f<T>(0.0f);
    dst_b[r * ldb + c] = in ? src_b[at] : from_f<T>(0.0f);
  }
}

__device__ __forceinline__ void zero_f(float* dst, int ld, int rows,
                                       int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    dst[(i / cols) * ld + i % cols] = 0.0f;
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in; once per
// kernel instantiation and process (single device).
template <typename K>
cudaError_t opt_in(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

// ------------------------------------------------------------ segment ids
//
// The segment-id variants (the Pallas bodies' has_segs): key j is visible
// to query i only where q_ids[i] == kv_ids[j], on top of the causal and
// ragged-end masks.  The ids are (batch, s) int32, one row per batch entry;
// a block of (batch*head) row bh reads row bh / heads, so they are never
// expanded per head.  A block stages its query and key ids in shared memory
// beside the tiles they belong to; a launch without ids (SEGS = false)
// reserves no bytes and compiles to the kernel without them.

// Shared-memory bytes of the staged ids: ROWS int32 values (0 without ids).
template <bool SEGS>
__host__ __device__ constexpr int id_bytes(int rows) {
  return SEGS ? round_up(rows * 4, 128) : 0;
}

// Stage ids [r0, r0 + rows) of one batch row; past n, 0 (such tokens are
// masked by the ragged-end test whatever their id).
__device__ __forceinline__ void load_ids(int* dst, const int* src, int r0,
                                         int rows, int n) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    dst[i] = r0 + i < n ? src[r0 + i] : 0;
  }
}

// The C entries' check of the id arguments: both pointers or neither, and
// whole batch rows of `heads` (batch*head) rows each.
inline bool bad_ids(const int* q_ids, const int* kv_ids, int bh, int heads) {
  if ((q_ids == nullptr) != (kv_ids == nullptr)) return true;
  return q_ids != nullptr && (heads <= 0 || bh % heads != 0);
}

// ---------------------------------------------------------------- dropout
//
// The dropout variants (the Pallas bodies' has_dropout): the probabilities
// multiplied into V are dropped where the counter hash of
// apex_tpu/ops/attention.py:71-95 (_mix32, _keep_mask) says so and the kept
// ones are scaled by the fp32 1 / (1 - rate); the row sum l and the lse are
// taken before dropout.  The backward replays the mask on p for dV and on
// dp before dz = p * (dp - delta).  The hash takes the GLOBAL flattened
// batch*head index bh (blockIdx.y here) and the ABSOLUTE query and key
// positions, never tile-local ones, so every rung, every tile and the plain
// versions draw the same mask for a seed: per row, h = mix32(seed ^ (bh *
// 0x9E3779B1)) once, then per pair r = mix32((h + q * 0x85EBCA6B) ^ (k *
// 0xC2B2AE3D)), kept iff (r >> 8) < keep_threshold = round(keep * 2^24).
// About 15 integer operations a pair, beside the tile products.  A launch
// without dropout (DROP = false) compiles to the kernel without it.

struct Dropout {
  unsigned seed;        // uint32 seed (the JAX dropout_seed)
  unsigned threshold;   // keep iff (hash >> 8) < threshold
  float inv_keep;       // fp32 1 / (1 - rate); 0 turns dropout off
};

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The per-(batch*head) part of the hash, hoisted out of the pair loops.
__device__ __forceinline__ unsigned drop_row(const Dropout& dr, long bh) {
  return mix32(dr.seed ^ (static_cast<unsigned>(bh) * 0x9E3779B1u));
}

__device__ __forceinline__ bool drop_keep(const Dropout& dr, unsigned h,
                                          int qi, int kj) {
  const unsigned r = mix32((h + static_cast<unsigned>(qi) * 0x85EBCA6Bu) ^
                           (static_cast<unsigned>(kj) * 0xC2B2AE3Du));
  return (r >> 8) < dr.threshold;
}

// ------------------------------------------------------------------- bias
//
// The additive bias (the Pallas bodies' has_bias): an fp32 score bias added
// after the scale and before the mask (apex_tpu/ops/attention_short.py:179-
// 184, :257-260; attention_mid.py:251-253, :369-371; attention.py:250-251,
// :465-466, :581-582).  The wrappers hand it over as an fp32 (nb, nh, sq,
// sk) tensor, nb in {1, batch} and nh in {1, heads}, with the element
// strides between batch rows and between heads (0 on a broadcast dim), so
// a shared or per-batch bias is never expanded per head.  Every instance
// takes the pointer and strides (null without a bias); a BIAS template
// flag, beside SEGS and DROP, decides whether an instance reads them.  A
// null test alone, uniform over the grid, kept the instance count down but
// slowed the instances without a bias by up to 17% on an H100 (the
// alternated A/B of apex_tpu_torch/tools/attention_ab.py, the test inside
// or hoisted out of the pair loop alike), while the flag cost no build time
// that showed (one nvcc a source, all at once).  Each lane reads the bias of
// the (query, key) pairs it owns straight from global memory into
// registers before the tile's products, so the loads' latency hides behind
// them (4-byte loads through the read-only path, no alignment asked of a
// row of sk values; pairs past (sq, sk) read nothing); nothing is staged in
// shared memory (the d = 128 tiles are near the 227 KB a block may use).
// The predicate alone decides what is masked: a pair the bias pushes to
// -1e30 stays visible, so a row the bias masks entirely is a uniform mean,
// as in JAX, not the "no visible key" row of segment ids.  The backward
// kernels add the same values to recompute p = exp(s - lse).  The gradient
// of the bias (the dQ kernels' DBIAS instances) is store_dbias below.

struct Bias {
  const float* ptr;   // (nb, nh, sq, sk) fp32, or null: no bias
  int stride_b;       // elements between batch rows' slabs (0: shared)
  int stride_h;       // elements between heads' slabs (0: shared)
};

// The (sq, sk) slab of flattened row bh = b_i * heads + h_i, or null.
__device__ __forceinline__ const float* bias_slab(const Bias& b, long bh,
                                                  int heads) {
  if (b.ptr == nullptr) return nullptr;
  return b.ptr + (bh / heads) * (long)b.stride_b +
         (bh % heads) * (long)b.stride_h;
}

// The bias of the pairs one warp owns, read into registers before a tile's
// products so that the loads' latency hides behind them (a block runs 4 or
// 8 warps): rows row0 + r (r < kRows) and columns col0 + lane + 32 j (j <
// J) are queries and keys, or with KEY_ROWS (the dK/dV kernels, whose warps
// own keys) keys and queries.  A pair past (sq, sk) reads nothing.
template <int J, bool KEY_ROWS>
__device__ __forceinline__ void load_bias(float (&bv)[kRows][J],
                                          const float* slab, int sq, int sk,
                                          int row0, int col0, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int qi = KEY_ROWS ? col0 + lane + 32 * j : row0 + r;
      const int kj = KEY_ROWS ? row0 + r : col0 + lane + 32 * j;
      bv[r][j] = qi < sq && kj < sk ? __ldg(slab + (long)qi * sk + kj) : 0.0f;
    }
  }
}

// s + b for a score s that is already scaled, in an instance that reads a
// bias (B), rounded once as the Pallas bodies' fp32 add is; s itself
// otherwise.  The forward and the backward add the same value to the same
// scaled score, so p = exp(s - lse) replays the forward's s.  b is taken
// by reference: an instance without a bias never reads its unset
// registers.
template <bool B>
__device__ __forceinline__ float biased(float s, const float& b) {
  if constexpr (B) {
    return __fadd_rn(s, b);
  } else {
    return s;
  }
}

// dBias (the Pallas bodies' dbias output under bias_grad): the gradient
// with respect to s * scale + bias of pair (qi, kj) of row bh, dz = p * (dp
// - delta), stored unscaled in fp32 to the (bh, sq, sk) output of an
// instance that emits it (DB), taken before dz is scaled and rounded to
// bf16 for dQ.  A lane owns columns lane + 32 j of its rows, so each store
// is 32 consecutive floats; ragged rows and columns store nothing.  The
// walk's causal skip stays: the wrapper zero-fills the output, so a
// skipped tile reads 0, as the Pallas bodies write there.
template <bool DB>
__device__ __forceinline__ void store_dbias(float* dbias, long bh, int sq,
                                            int sk, int qi, int kj,
                                            float dz) {
  if constexpr (DB) {
    if (qi < sq && kj < sk) dbias[(bh * sq + qi) * sk + kj] = dz;
  }
}

// The C entries' check of the bias arguments: whole batch rows of `heads`
// rows each, strides that are not negative, and no dBias output without
// a bias.
inline bool bad_bias(const float* bias, int stride_b, int stride_h, int bh,
                     int heads, const float* dbias = nullptr) {
  if (bias == nullptr) return dbias != nullptr;
  return heads <= 0 || bh % heads != 0 || stride_b < 0 || stride_h < 0;
}

}  // namespace
}  // namespace attn
