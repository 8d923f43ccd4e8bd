// Weight-dequantizing matmul for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/dequant_matmul.py::_int8_kernel and _int4_kernel,
// the Pallas TPU kernels behind dequant_matmul: out (m, n) = x (m, k) @
// dequant(W), with W stored block-quantized along the output features:
//  - int8: q (k, n) int8, scales (k, n / block) fp32;
//  - int4: q (k, n / 2) packed bytes in the halves layout: packed column
//    c holds output column c in its low nibble and column c + n/2 in its
//    high nibble, each sign-extended by ((x & 0xF) ^ 8) - 8; scales
//    (k, n / block) as for int8, so column c's scale is scales[r, c/block]
//    in either half.
// The arithmetic is the Pallas bodies': x is upcast to fp32, each weight
// element is dequantized in fp32 with the scale of its own (k row, n
// block), the products are summed in fp32 and the result is rounded once
// to x's dtype.  The scale belongs to (k, n / block), so it cannot be
// taken out of the k-sum: dequantizing costs one multiply per weight
// element.  No operand goes to the tensor cores (bf16 or int8 operands
// would be another function).
//
// Translation from the TPU kernels:
//  - The Pallas kernel holds the whole x (m, k) in VMEM and walks
//    output-column tiles sized by a VMEM budget (_pick_bn).  Here x is
//    tiled too (at a 2304-token prefill x is 37 MB in fp32) and k is
//    walked inside the block.
//  - The int4 kernel's (2, m, n/2) output slabs and the concatenation
//    after it exist for the TPU's lane layout.  Here each packed byte
//    gives columns c and c + n/2, and the kernel writes both straight
//    into (m, n).
//
// Two regimes, two kernels:
//  - decode (m <= 8 rows, the serving slots): the product streams the
//    weights, so it is bound by their bytes (int8 3.1 MB for the
//    flagship's qkv; int4 half of that).  dequant_skinny: a block of 256
//    threads owns 256 output columns and a slice of k; a thread loads 16
//    int8 bytes (or 8 packed int4 bytes) of one k row at a time, 16
//    threads cover a row's 256 columns with one coalesced line, and the
//    16 thread rows of the block walk the k slice.  With only 4-16
//    column tiles per projection, k is split across blocks so that the
//    132 SMs have work; each block writes its partial sums to a
//    workspace and a second launch adds the splits in a fixed order.  No
//    floating-point atomics: a run repeats bit for bit.
//  - prefill (m > 8): bound by fp32 arithmetic on the CUDA cores (4.3
//    GFLOP for fc1 at m = 512).  dequant_tiled: 128 x 128 output tiles,
//    k in steps of 32, each thread an 8 x 8 sub-tile; the next step's x
//    and weight bytes are loaded into registers while the current step's
//    shared-memory tiles are used, and the weight tile is dequantized on
//    its way into shared memory.  k is split the same way when the output
//    tiles alone would leave SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSkinnyMaxM = 8;     // rows the decode kernel takes
constexpr int kSkinnyCols = 256;   // output columns of a decode block
constexpr int kSkinnyMaxKc = 256;  // k rows of one decode block (x in smem)
constexpr int BM = 128, BN = 128, BK = 32;   // prefill tiles

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 consecutive elements of x as fp32 (16- or 32-byte aligned)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float nibble_lo(int p) {
  return static_cast<float>(((p & 0xF) ^ 8) - 8);
}
__device__ __forceinline__ float nibble_hi(int p) {
  return static_cast<float>((((p >> 4) & 0xF) ^ 8) - 8);
}

// The 16 dequantized weights a thread takes from one k row: int8 columns
// [c, c + 16), or int4 packed columns [c, c + 8) giving output columns
// [c, c + 8) (low nibbles) and [c + nq, c + nq + 8) (high nibbles).
template <bool kInt4>
__device__ __forceinline__ void load_weights(const int8_t* __restrict__ q,
                                             const float* __restrict__ scales,
                                             long row, int c, int nq, int nb,
                                             int block, float* w) {
  const float* srow = scales + row * nb;
  if constexpr (!kInt4) {
    const uint4 v = *reinterpret_cast<const uint4*>(q + row * nq + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    const float s = srow[c / block];
#pragma unroll
    for (int e = 0; e < 16; ++e) w[e] = static_cast<float>(b[e]) * s;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(q + row * nq + c);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
    const float slo = srow[c / block];
    const float shi = srow[(c + nq) / block];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w[e] = nibble_lo(b[e]) * slo;
      w[8 + e] = nibble_hi(b[e]) * shi;
    }
  }
}

// ----------------------------------------------------------------- decode
// Grid (column tiles, k splits).  tx = tid % 16 picks a thread's 16
// output columns, ty = tid / 16 its k rows (ty, ty + 16, ...) of the
// block's slice [k0, k0 + kc).
template <typename T, int MT, bool kInt4>
__global__ void __launch_bounds__(kThreads)
dequant_skinny(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scales, T* __restrict__ out,
               float* __restrict__ work, int m, int k, int n, int block,
               int kc) {
  constexpr int W = kInt4 ? 8 : 16;    // packed columns a thread loads
  __shared__ __align__(16) float xs[kSkinnyMaxKc][MT];
  __shared__ float red[kThreads / 32][kSkinnyCols];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = kInt4 ? n / 2 : n;
  const int nb = n / block;
  const int c0 = blockIdx.x * 16 * W;
  const int c = c0 + tx * W;
  const int k0 = blockIdx.y * kc;
  const int rows = min(kc, k - k0);

  // x[:, k0:k0 + rows] as fp32, rows past m zero
  for (int idx = tid; idx < rows * MT; idx += kThreads) {
    const int i = idx / rows, r = idx % rows;
    xs[r][i] = i < m ? to_float(x[(long)i * k + k0 + r]) : 0.0f;
  }
  __syncthreads();

  float acc[MT][16];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.0f;
  if (c < nq) {
#pragma unroll 4
    for (int r = ty; r < rows; r += 16) {
      float w[16];
      load_weights<kInt4>(q, scales, (long)(k0 + r), c, nq, nb, block, w);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float xv = xs[r][i];
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[i][e] = fmaf(xv, w[e], acc[i][e]);
      }
    }
  }

  // reduce over the 16 thread rows in a fixed order: the two halves of a
  // warp by one shuffle, then the 8 warps in order through shared memory
  const int warp = tid / 32, lane = tid % 32;
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= m) break;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], 16);
    if (lane < 16) {
#pragma unroll
      for (int e = 0; e < 16; ++e) red[warp][tx * 16 + e] = acc[i][e];
    }
    __syncthreads();
    // thread t sums local column t: tx' = t / 16, e = t % 16
    const int t = tid, owner = t / 16, e = t % 16;
    const int oc = c0 + owner * W;            // the owner's packed column
    if (oc < nq) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) total += red[w][t];
      const int col = kInt4 ? (e < 8 ? oc + e : nq + oc + e - 8) : oc + e;
      if (split)
        work[((long)blockIdx.y * m + i) * n + col] = total;
      else
        store(out + (long)i * n + col, total);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- prefill
// Grid (column tiles, row tiles, k splits).  The block's 128 output
// columns: int8 [n0, n0 + 128); int4 the packed columns [p0, p0 + 64),
// i.e. output columns [p0, p0 + 64) and [p0 + n/2, p0 + n/2 + 64).
// Shared-memory column lc < 64 is the first range, lc >= 64 the second.
template <bool kInt4>
__device__ __forceinline__ int packed_col(int tile, int lc) {
  return kInt4 ? tile * (BN / 2) + lc % (BN / 2) : tile * BN + lc;
}

template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads)
dequant_tiled(const T* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scales, T* __restrict__ out,
              float* __restrict__ work, int m, int k, int n, int block,
              int kc) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = kInt4 ? n / 2 : n;
  const int nb = n / block;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kc;
  const int k_end = min(k, k_begin + kc);

  // x loads: row tid / 2, 16 consecutive k from (tid % 2) * 16
  const int a_row = tid / 2, a_k = (tid % 2) * 16;
  const bool a_live = m0 + a_row < m;
  // weight loads: k row tid / 8; int8 columns (tid % 8) * 16 (16 bytes),
  // int4 packed columns (tid % 8) * 8 (8 bytes)
  const int b_row = tid / 8, b_j = tid % 8;
  const int b_c = kInt4 ? blockIdx.x * (BN / 2) + b_j * 8
                        : blockIdx.x * BN + b_j * 16;
  const bool b_live = b_c < nq;

  float a_reg[16], b_reg[16];
  auto load = [&](int kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = kt + a_k + 8 * h;
      if (a_live && kk < k_end)
        load8(x + (long)(m0 + a_row) * k + kk, a_reg + 8 * h);
      else
#pragma unroll
        for (int e = 0; e < 8; ++e) a_reg[8 * h + e] = 0.0f;
    }
    if (b_live && kt + b_row < k_end)
      load_weights<kInt4>(q, scales, (long)(kt + b_row), b_c, nq, nb, block,
                          b_reg);
    else
#pragma unroll
      for (int e = 0; e < 16; ++e) b_reg[e] = 0.0f;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (k_begin < k_end) load(k_begin);
  for (int kt = k_begin; kt < k_end; kt += BK) {
#pragma unroll
    for (int e = 0; e < 16; ++e) As[a_k + e][a_row] = a_reg[e];
    if constexpr (!kInt4) {
#pragma unroll
      for (int e = 0; e < 16; e += 4)
        *reinterpret_cast<float4*>(&Bs[b_row][b_j * 16 + e]) =
            make_float4(b_reg[e], b_reg[e + 1], b_reg[e + 2], b_reg[e + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        *reinterpret_cast<float4*>(&Bs[b_row][b_j * 8 + e]) =
            make_float4(b_reg[e], b_reg[e + 1], b_reg[e + 2], b_reg[e + 3]);
        *reinterpret_cast<float4*>(&Bs[b_row][BN / 2 + b_j * 8 + e]) =
            make_float4(b_reg[8 + e], b_reg[9 + e], b_reg[10 + e],
                        b_reg[11 + e]);
      }
    }
    __syncthreads();
    if (kt + BK < k_end) load(kt + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lc = j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4;
      const int pc = packed_col<kInt4>(blockIdx.x, lc);
      if (pc >= nq) continue;
      const int col = kInt4 && lc >= BN / 2 ? nq + pc : pc;
      if (split)
        work[((long)blockIdx.z * m + row) * n + col] = acc[i][j];
      else
        store(out + (long)row * n + col, acc[i][j]);
    }
  }
}

// The splits' partial sums, added in order 0, 1, ... and rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_splits(const float* __restrict__ work, T* __restrict__ out, long mn,
              int splits) {
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= mn) return;
  float total = 0.0f;
  for (int z = 0; z < splits; ++z) total += work[z * mn + idx];
  store(out + idx, total);
}

template <typename T, bool kInt4>
cudaError_t launch(const void* x, const int8_t* q, const float* scales,
                   void* out, float* work, int m, int k, int n, int block,
                   int kc, int splits, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int nq = kInt4 ? n / 2 : n;
  if (m <= kSkinnyMaxM) {
    if (kc > kSkinnyMaxKc) return cudaErrorInvalidValue;
    const int cols = kInt4 ? 128 : 256;     // packed columns of a block
    dim3 grid((nq + cols - 1) / cols, splits);
    if (m <= 4)
      dequant_skinny<T, 4, kInt4><<<grid, kThreads, 0, stream>>>(
          xt, q, scales, ot, work, m, k, n, block, kc);
    else
      dequant_skinny<T, 8, kInt4><<<grid, kThreads, 0, stream>>>(
          xt, q, scales, ot, work, m, k, n, block, kc);
  } else {
    if (kc % BK) return cudaErrorInvalidValue;
    const int cols = kInt4 ? BN / 2 : BN;
    dim3 grid((nq + cols - 1) / cols, (m + BM - 1) / BM, splits);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    dequant_tiled<T, kInt4><<<grid, kThreads, 0, stream>>>(
        xt, q, scales, ot, work, m, k, n, block, kc);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long mn = (long)m * n;
  reduce_splits<T><<<(mn + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      work, ot, mn, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k) fp32 (dtype 0) or bf16 (dtype 1); q int8 (k, n) or packed int4
// (k, n/2) (int4 = 1); scales (k, n/block) fp32; out (m, n) in x's dtype;
// work (splits, m, n) fp32 when splits > 1.  m <= 8 takes the decode
// kernel (kc <= 256), larger m the tiled kernel (kc a multiple of 32);
// k is cut into splits of kc rows.  Needs k % 8 == 0 and, for int8,
// n % 16 == 0 and block % 16 == 0; for int4, (n/2) % 8 == 0, block % 8
// == 0 and (n/2) % block == 0.  Returns a cudaError_t code (0 = success).
int dequant_matmul(const void* x, const void* q, const float* scales,
                   void* out, float* work, int m, int k, int n, int block,
                   int int4, int dtype, int kc, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || k < 8 || k % 8 || n < 1 || block < 1 || n % block ||
      kc < 1 || splits < 1 || (long)(splits - 1) * kc >= k ||
      (long)splits * kc < k || (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  if (int4 ? (n % 2 || (n / 2) % 8 || block % 8 || (n / 2) % block)
           : (n % 16 || block % 16))
    return cudaErrorInvalidValue;
  const int8_t* qb = static_cast<const int8_t*>(q);
#define DEQUANT(T, I4) \
  return launch<T, I4>(x, qb, scales, out, work, m, k, n, block, kc, splits, s)
  if (dtype == 0 && !int4) DEQUANT(float, false);
  if (dtype == 0 && int4) DEQUANT(float, true);
  if (dtype == 1 && !int4) DEQUANT(__nv_bfloat16, false);
  if (dtype == 1 && int4) DEQUANT(__nv_bfloat16, true);
#undef DEQUANT
  return cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
