// Short-sequence attention forward for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/attention_short.py::_short_fwd_kernel, the
// single-pass Pallas TPU kernel that holds a whole (s <= 512) K/V
// sequence in VMEM and computes an exact softmax in one pass.
//
// Why the design differs: for s = 512, d = 128 in bf16, K plus V of one
// head is 256 KB, more than the 227 KB of shared memory a block may use,
// so the whole-sequence pass does not fit.  Instead one block owns one
// (batch*head, 64-row query tile) and loops over 64-key K/V tiles with an
// online softmax (running max m, running sum l, rescaled accumulator),
// which gives the exact softmax up to rounding.  Blocks run in parallel
// in any order; nothing is carried between them.
//
//  - 4 warps, each owns 16 query rows of the tile end to end: its slice of
//    S = Q K^T, its softmax rows, its slice of O += P V.  Only the K/V
//    tile loads are shared, so the warps synchronise twice per tile.
//  - bf16: both products run on the tensor cores through WMMA
//    (16x16x16 bf16 fragments, fp32 accumulate).  fp32: a full-fp32 path
//    of plain FMAs from shared memory (no TF32), matching the JAX
//    kernel's Precision.HIGHEST for fp32 inputs.
//  - causal: key tiles wholly above the diagonal of the query tile are
//    skipped; the diagonal tile and the ragged tail (keys >= sk) are
//    masked with the finite fill -1e30, and masked probabilities are
//    exactly zero.
//  - outputs: O in the input dtype and the row logsumexp (fp32), kept for
//    the backward a later slice adds.
//
// What bounds it on the card: at s = 512 causal, one (b*h) slice does
// 2 * 2 * d * s(s+1)/2 flops over 4 * s * d * 2 bytes, ~130 flop/byte,
// under the H100's ~295 flop/byte bf16 balance point: the minimum time is
// set by the bytes moved, but this simple kernel (WMMA through shared
// memory, 110 KB of it per bf16 block, so at most two blocks per SM) is
// far from either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kWarps = 4;      // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory layout of one block, in bytes.  The tensor-core path pads
// its rows by 8 bf16 / 4 fp32 (WMMA needs ldm % 8 == 0 for 16-bit and
// % 4 for fp32, and 32-byte aligned fragment pointers); the fp32 path
// pads K rows by one float so that lanes reading 32 different K rows at
// one column hit 32 different banks.
template <typename T, int D>
struct Layout {
  static constexpr bool kTC = sizeof(T) == 2;
  static constexpr int LDQ = kTC ? D + 8 : D;
  static constexpr int LDK = kTC ? D + 8 : D + 1;
  static constexpr int LDV = kTC ? D + 8 : D;
  static constexpr int LDS = kTC ? kBK + 4 : kBK;   // fp32 scores
  static constexpr int LDP = kBK + 8;               // bf16 probabilities
  static constexpr int LDO = kTC ? D + 4 : D;       // fp32 accumulator
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = round_up(Q_OFF + kBQ * LDQ * (int)sizeof(T), 128);
  static constexpr int V_OFF = round_up(K_OFF + kBK * LDK * (int)sizeof(T), 128);
  static constexpr int S_OFF = round_up(V_OFF + kBK * LDV * (int)sizeof(T), 128);
  static constexpr int P_OFF = round_up(S_OFF + kBQ * LDS * 4, 128);
  static constexpr int O_OFF =
      round_up(P_OFF + (kTC ? kBQ * LDP * 2 : 0), 128);
  static constexpr int BYTES = round_up(O_OFF + kBQ * LDO * 4, 128);
};

// S[16 x kBK] = Q[16 x D] K^T for one warp, on the tensor cores.
template <int D, typename L>
__device__ void warp_qk_tc(const __nv_bfloat16* Qs, const __nv_bfloat16* Ks,
                           float* Ss, int row0) {
  for (int n = 0; n < kBK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + row0 * L::LDQ + kk * 16, L::LDQ);
      // K^T as a column-major (D x kBK) operand: element (k, n) is
      // Ks[n * LDK + k]
      wmma::load_matrix_sync(b, Ks + (n * 16) * L::LDK + kk * 16, L::LDK);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Ss + row0 * L::LDS + n * 16, acc, L::LDS,
                            wmma::mem_row_major);
  }
}

// O[16 x D] += P[16 x kBK] V[kBK x D] for one warp, on the tensor cores.
template <int D, typename L>
__device__ void warp_pv_tc(const __nv_bfloat16* Ps, const __nv_bfloat16* Vs,
                           float* Os, int row0) {
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, Os + row0 * L::LDO + n * 16, L::LDO,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, Ps + row0 * L::LDP + kk * 16, L::LDP);
      wmma::load_matrix_sync(b, Vs + (kk * 16) * L::LDV + n * 16, L::LDV);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Os + row0 * L::LDO + n * 16, acc, L::LDO,
                            wmma::mem_row_major);
  }
}

// The same two products in full fp32 from shared memory.
template <int D, typename L>
__device__ void warp_qk_fp32(const float* Qs, const float* Ks, float* Ss,
                             int row0, int lane) {
  float acc[kRowsPerWarp][2];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int k = 0; k < D; ++k) {
    const float k0 = Ks[lane * L::LDK + k];
    const float k1 = Ks[(lane + 32) * L::LDK + k];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float q = Qs[(row0 + r) * L::LDQ + k];
      acc[r][0] = fmaf(q, k0, acc[r][0]);
      acc[r][1] = fmaf(q, k1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    Ss[(row0 + r) * L::LDS + lane] = acc[r][0];
    Ss[(row0 + r) * L::LDS + lane + 32] = acc[r][1];
  }
}

template <int D, typename L>
__device__ void warp_pv_fp32(const float* Ps, const float* Vs, float* Os,
                             int row0, int lane) {
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float* p = Ps + (row0 + r) * L::LDS;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int col = lane + 32 * i;
      float acc = Os[(row0 + r) * L::LDO + col];
      for (int j = 0; j < kBK; ++j) acc = fmaf(p[j], Vs[j * L::LDV + col], acc);
      Os[(row0 + r) * L::LDO + col] = acc;
    }
  }
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

// q, k, v, out: (bh, s, D) contiguous; lse: (bh, sq) fp32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int causal,
                 float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q_OFF);
  T* Ks = reinterpret_cast<T*>(smem + L::K_OFF);
  T* Vs = reinterpret_cast<T*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;
  const long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  // query tile (rows past sq are zero and never stored) and a zero
  // accumulator
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * L::LDQ + c] = (q0 + r < sq) ? qb[(long)(q0 + r) * D + c] : from_f<T>(0.0f);
    Os[r * L::LDO + c] = 0.0f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's products are done with K/V
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < sk;
      Ks[r * L::LDK + c] = in ? kb[(long)(k0 + r) * D + c] : from_f<T>(0.0f);
      Vs[r * L::LDV + c] = in ? vb[(long)(k0 + r) * D + c] : from_f<T>(0.0f);
    }
    __syncthreads();

    if constexpr (L::kTC) {
      warp_qk_tc<D, L>(Qs, Ks, Ss, row0);
    } else {
      warp_qk_fp32<D, L>(Qs, Ks, Ss, row0, lane);
    }
    __syncwarp();

    // online softmax over this warp's rows; lane owns columns lane and
    // lane + 32 of the tile
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      const int qi = q0 + row;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kj = k0 + lane + 32 * h;
        ok[h] = kj < sk && (!causal || kj <= qi);
        s[h] = ok[h] ? Ss[row * L::LDS + lane + 32 * h] * scale : kNegInf;
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
        if constexpr (L::kTC) {
          Ps[row * L::LDP + lane + 32 * h] = __float2bfloat16(p[h]);
        } else {
          Ss[row * L::LDS + lane + 32 * h] = p[h];
        }
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) Os[row * L::LDO + lane + 32 * i] *= corr;
    }
    __syncwarp();

    if constexpr (L::kTC) {
      warp_pv_tc<D, L>(Ps, Vs, Os, row0);
    } else {
      warp_pv_fp32<D, L>(Ss, Vs, Os, row0, lane);
    }
    __syncwarp();
  }

  // normalise and store this warp's rows
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    if (qi >= sq) continue;
    const float ll = fmaxf(l[r], 1e-30f);
    const float inv = 1.0f / ll;
    T* o = out + (bh * sq + qi) * D;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      o[lane + 32 * i] = from_f<T>(Os[row * L::LDO + lane + 32 * i] * inv);
    }
    if (lane == 0) lse[bh * sq + qi] = m[r] + logf(ll);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int bh, int sq, int sk, int causal,
                   float scale, cudaStream_t stream) {
  using L = Layout<T, D>;
  // above 48 KB of dynamic shared memory a kernel must opt in; once per
  // instantiation and process (single device)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        short_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::BYTES);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  dim3 grid((sq + kBQ - 1) / kBQ, bh);
  short_fwd_kernel<T, D><<<grid, kThreads, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16.  Returns a cudaError_t code (0 = success).
int short_fwd(const void* q, const void* k, const void* v, void* out,
              float* lse, int bh, int sq, int sk, int d, int dtype,
              int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, out, lse, bh, sq, sk, causal, scale, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, lse, bh, sq, sk, causal, scale, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, lse, bh, sq, sk, causal,
                                      scale, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, lse, bh, sq, sk, causal,
                                     scale, s);
  return cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
