// Fused LayerNorm / RMSNorm for Hopper (sm_90a): the forward and a fused
// backward.
//
// The forward replaces apex_tpu/ops/layer_norm.py::_ln_fwd_kernel (:66,
// called at :95), the Pallas TPU kernel behind all five entries of
// ops/layer_norm.py, with the affine that JAX applies in XLA after it
// fused into the epilogue.  The backward replaces no Pallas kernel: JAX
// computes it in XLA (_normalize_bwd, :168-182, with the affine's
// transpose outside the custom_vjp, :221-225); the reference it was built
// from (fused_layer_norm_cuda) does it in CUDA, and without a kernel the
// port ran it as ~20 plain PyTorch launches, most of them writing an fp32
// (rows, hidden) intermediate.
//
// The function, as the plain versions in ops/layer_norm.py compute it:
//  forward  mean = mean(x) (0 for RMSNorm), var = mean((x - mean)^2)
//           (centred, as JAX computes it), invvar = rsqrt(var + eps),
//           xhat = (x - mean) * invvar in fp32, rounded to x's dtype, then
//           y = xhat_r * w + b in fp32 (a multiply and an add, each
//           rounded, as the plain version's two operations), stored in
//           x's dtype; mean and invvar stored as fp32 (rows,).
//  backward xhat recomputed from the saved statistics, xhat_r its
//           rounding to x's dtype, dxhat = round_x(dy * w),
//           c1 = mean(dxhat) (layer norm only), c2 = mean(dxhat * xhat),
//           dx = round_x(invvar * ((dxhat - c1) - xhat * c2)),
//           dscale = sum_rows(dy * xhat_r), dbias = sum_rows(dy), each
//           stored in the weight's dtype.
//
// Both are bound by bytes: a few operations per element moved.  At the
// training shape (8192 rows x 1024, bf16) the forward moves 33.6 MB (x
// read, y written) and the backward 50.3 MB (x and dy read, dx written),
// 0.010 and 0.015 ms at 3.35 TB/s.
//
// Design:
//  - One warp per row, no shared memory and no __syncthreads on the row's
//    path.  A lane holds 32 elements of a 1024-element chunk in registers,
//    loaded as 16-byte vectors (four of bf16/fp16, eight of fp32; lane l
//    takes vectors l, l + 32, ..., so a warp's load is 512 contiguous
//    bytes).  A hidden that is not a multiple of the vector (8 elements
//    of bf16/fp16, 4 of fp32), or a row not 16-byte aligned, takes the
//    scalar instance (lane l takes elements l, l + 32, ...).
//  - Rows of one chunk (hidden <= 1024, the RESIDENT instances) stay in
//    registers across the passes over the row.  Longer rows loop over
//    their chunks and read each chunk again for the next pass (from L1 or
//    L2).
//  - Row reductions by __shfl_xor_sync: every lane ends with the sum, in
//    the same order every run.
//  - Forward: blocks of four warps, at most 528 (four an SM); a warp walks
//    rows g, g + G, ... with the next row's loads in flight, the weight and
//    bias in registers.
//  - Backward: blocks of eight warps, at most 132 (one an SM); a block owns
//    a contiguous run of rows_per_block rows, its warp w rows w, w + warps,
//    ...; a lane adds dy * xhat_r and dy for its columns over the rows its
//    warp visits (registers for one chunk, shared memory per warp past
//    that), then the block adds its warps' sums in warp order and writes
//    one (hidden,) partial of each into a (2, blocks, hidden) fp32 scratch.
//    ln_bwd_fold adds each column's partials in eight runs of blocks, each
//    in block order, then the runs in order, and writes dscale and dbias.
//    No float atomics: the same inputs give the same bits on every run,
//    and the plain version (ops/layer_norm.py, _column_sums_plain) adds in
//    the same order, so it gives the same sums.  A 16-bit x keeps pass 1's
//    rounded dxhat for pass 2; roundings to 16 bits go two at a time
//    (cvt.rn.bf16x2.f32 / f16x2).
//  - The grids and the scratch come from the shapes alone (ops/layer_norm.py,
//    layer_norm_plan), so a call can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using fp16 = __half;

constexpr int kLanes = 32;
constexpr int kLaneElems = 32;                   // a lane's share of a chunk
constexpr int kChunk = kLanes * kLaneElems;      // 1024 elements
constexpr int kMaxWarps = 8;                     // a block's warps at most
constexpr int kFoldWarps = 8;
constexpr int kSmemLimit = 224 * 1024;   // the backward's block at most

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(fp16 v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ fp16 from_f<fp16>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// P (1 or 2) fp32 values rounded to T in place: a pair by one packed
// conversion (conversions issue at a fraction of the fp32 rate), with the
// same result as two single ones
template <typename T, int P>
__device__ __forceinline__ void round_p(float (&a)[P]) {
  if constexpr (P == 2 && std::is_same<T, bf16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[0], a[1]);
    a[0] = __low2float(h);
    a[1] = __high2float(h);
  } else if constexpr (P == 2 && std::is_same<T, fp16>::value) {
    const __half2 h = __floats2half2_rn(a[0], a[1]);
    a[0] = __low2float(h);
    a[1] = __high2float(h);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) a[i] = round_to<T>(a[i]);
  }
}

// P fp32 values stored as T at dst (4-byte aligned for a pair)
template <typename T, int P>
__device__ __forceinline__ void put_p(T* dst, const float (&a)[P]) {
  if constexpr (P == 2 && std::is_same<T, bf16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a[0], a[1]);
  } else if constexpr (P == 2 && std::is_same<T, fp16>::value) {
    *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(a[0], a[1]);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) dst[i] = from_f<T>(a[i]);
  }
}

// N fp32 values at p in shared memory (16-byte aligned when N % 4 == 0)
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      a[i] = t.x; a[i + 1] = t.y; a[i + 2] = t.z; a[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void sts(float* p, const float (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = a[i];
  }
}

// VEC elements of T moved as one access (two 16-byte ones for 32 bytes)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, VEC>& v) {
  *reinterpret_cast<Vec<T, VEC>*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a[0] + ... + a[N - 1] pairwise (N a power of two): short dependent chains
template <int N>
__device__ __forceinline__ float tree_sum(float (&a)[N]) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) a[i] += a[i + w];
  return a[0];
}

// the first element of this lane's vector v in chunk c
template <int VEC>
__device__ __forceinline__ int elem(int c, int v, int lane) {
  return c * kChunk + (v * kLanes + lane) * VEC;
}

// this lane's vectors of chunk c of a row (those past hidden untouched)
template <typename T, int VEC, int NV>
__device__ __forceinline__ void load_chunk(const T* row, int c, int hidden,
                                           int lane, Vec<T, VEC> (&buf)[NV]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = elem<VEC>(c, v, lane);
    if (i < hidden) buf[v] = load_vec<T, VEC>(row + i);
  }
}

// ------------------------------------------------------------- forward
// A warp takes rows g, g + G, ... (g its index in the grid, G the grid's
// warps).  RESIDENT: the weight and bias (as fp32) and the first row are
// loaded together, before any reduction, and the next row's loads are in
// flight while a row is reduced and written.
template <typename T, typename W, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
    ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                  const W* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mean_out,
                  float* __restrict__ invvar_out, int rows, int hidden,
                  float eps, int rms) {
  constexpr int NV = kLaneElems / VEC;
  constexpr int P = VEC % 2 == 0 ? 2 : 1;   // elements a conversion
  const int lane = threadIdx.x % kLanes;
  const int warps = blockDim.x / kLanes;
  const long long stride = (long long)gridDim.x * warps;
  long long row = (long long)blockIdx.x * warps + threadIdx.x / kLanes;
  if (row >= rows) return;
  const int chunks = RESIDENT ? 1 : (hidden + kChunk - 1) / kChunk;
  const float inv_h = 1.f / (float)hidden;
  Vec<T, VEC> buf[NV], next[NV];
  float wr[RESIDENT ? kLaneElems : 1], br[RESIDENT ? kLaneElems : 1];
  if (RESIDENT) {
    load_chunk<T, VEC, NV>(x + row * hidden, 0, hidden, lane, buf);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = elem<VEC>(0, v, lane);
      Vec<W, VEC> wv, bv;
      if (i < hidden) {
        wv = load_vec<W, VEC>(w + i);
        if (b != nullptr) bv = load_vec<W, VEC>(b + i);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        wr[v * VEC + k] = i < hidden ? to_f(wv.v[k]) : 0.f;
        br[v * VEC + k] = i < hidden && b != nullptr ? to_f(bv.v[k]) : 0.f;
      }
    }
  }

  for (; row < rows; row += stride) {
    const T* xr = x + row * hidden;
    T* yr = y + row * hidden;
    if (RESIDENT && row + stride < rows)
      load_chunk<T, VEC, NV>(xr + stride * hidden, 0, hidden, lane, next);
    float mean = 0.f;
    if (!rms) {
      float s = 0.f;
      for (int c = 0; c < chunks; ++c) {
        if (!RESIDENT) load_chunk<T, VEC, NV>(xr, c, hidden, lane, buf);
        float part[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          part[v] = 0.f;
          if (elem<VEC>(c, v, lane) < hidden)
#pragma unroll
            for (int k = 0; k < VEC; ++k) part[v] += to_f(buf[v].v[k]);
        }
        s += tree_sum(part);
      }
      mean = warp_sum(s) * inv_h;
    }
    float sq = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (!RESIDENT) load_chunk<T, VEC, NV>(xr, c, hidden, lane, buf);
      float part[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        part[v] = 0.f;
        if (elem<VEC>(c, v, lane) < hidden)
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float d = to_f(buf[v].v[k]) - mean;
            part[v] = fmaf(d, d, part[v]);
          }
      }
      sq += tree_sum(part);
    }
    const float invvar = rsqrtf(warp_sum(sq) * inv_h + eps);
    for (int c = 0; c < chunks; ++c) {
      if (!RESIDENT) load_chunk<T, VEC, NV>(xr, c, hidden, lane, buf);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = elem<VEC>(c, v, lane);
        if (i >= hidden) continue;
        Vec<W, VEC> wv, bv;
        if (!RESIDENT) {
          wv = load_vec<W, VEC>(w + i);
          if (b != nullptr) bv = load_vec<W, VEC>(b + i);
        }
        Vec<T, VEC> out;
#pragma unroll
        for (int k = 0; k < VEC; k += P) {
          float o[P];
#pragma unroll
          for (int e = 0; e < P; ++e)
            o[e] = __fmul_rn(__fsub_rn(to_f(buf[v].v[k + e]), mean), invvar);
          round_p<T, P>(o);
#pragma unroll
          for (int e = 0; e < P; ++e) {
            o[e] = __fmul_rn(o[e], RESIDENT ? wr[v * VEC + k + e]
                                            : to_f(wv.v[k + e]));
            if (b != nullptr)
              o[e] = __fadd_rn(o[e], RESIDENT ? br[v * VEC + k + e]
                                              : to_f(bv.v[k + e]));
          }
          put_p<T, P>(&out.v[k], o);
        }
        store_vec<T, VEC>(yr + i, out);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      invvar_out[row] = invvar;
    }
    if (RESIDENT) {
#pragma unroll
      for (int v = 0; v < NV; ++v) buf[v] = next[v];
    }
  }
}

// ------------------------------------------------------------ backward
// this lane's VEC weights at element i (its vector v): from registers
// (RESIDENT) or global memory
template <typename W, int VEC, bool RESIDENT, int R>
__device__ __forceinline__ void weights(const W* w, const float (&wr)[R],
                                        int i, int v, float (&wk)[VEC]) {
  if constexpr (RESIDENT) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) wk[k] = wr[v * VEC + k];
  } else {
    const Vec<W, VEC> wv = load_vec<W, VEC>(w + i);
#pragma unroll
    for (int k = 0; k < VEC; ++k) wk[k] = to_f(wv.v[k]);
  }
}

// shared memory: [warps][2][hidden] fp32, each warp's column sums of
// dy * xhat_r and dy (accumulated there past one chunk; written there
// from registers for one).  RESIDENT: the weight (fp32) and this lane's
// column sums stay in registers across the warp's rows, and a 16-bit
// x keeps pass 1's rounded dxhat (exact in T) for pass 2.
template <typename T, typename W, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const W* __restrict__ w, const float* __restrict__ mean,
                  const float* __restrict__ invvar, T* __restrict__ dx,
                  float* __restrict__ partials, int rows, int hidden,
                  int rows_per_block, int rms) {
  constexpr int NV = kLaneElems / VEC;
  constexpr int P = VEC % 2 == 0 ? 2 : 1;   // elements a conversion
  constexpr bool KEEP = RESIDENT && sizeof(T) == 2;
  constexpr int R = RESIDENT ? kLaneElems : 1;
  extern __shared__ float sums[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const bool cols = partials != nullptr;
  float* mine = sums + (size_t)warp * 2 * hidden;   // [2][hidden]
  const int chunks = RESIDENT ? 1 : (hidden + kChunk - 1) / kChunk;
  const float inv_h = 1.f / (float)hidden;

  float acc_s[R], acc_b[R], wr[R];
  if (RESIDENT) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = elem<VEC>(0, v, lane);
      Vec<W, VEC> wv;
      if (i < hidden) wv = load_vec<W, VEC>(w + i);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc_s[v * VEC + k] = 0.f;
        acc_b[v * VEC + k] = 0.f;
        wr[v * VEC + k] = i < hidden ? to_f(wv.v[k]) : 0.f;
      }
    }
  } else if (cols) {
    for (int i = lane; i < 2 * hidden; i += kLanes) mine[i] = 0.f;
    __syncwarp();
  }

  const long long first = (long long)blockIdx.x * rows_per_block;
  const long long end =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  Vec<T, VEC> xb[NV], gb[NV], dh[KEEP ? NV : 1];
  for (long long row = first + warp; row < end; row += warps) {
    const T* xr = x + row * hidden;
    const T* gr = dy + row * hidden;
    T* dr = dx + row * hidden;
    const float m = mean[row], iv = invvar[row];
    // pass 1: c1 = mean(dxhat), c2 = mean(dxhat * xhat)
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < chunks; ++c) {
      load_chunk<T, VEC, NV>(xr, c, hidden, lane, xb);
      load_chunk<T, VEC, NV>(gr, c, hidden, lane, gb);
      float p1[NV], p2[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = elem<VEC>(c, v, lane);
        p1[v] = p2[v] = 0.f;
        if (i >= hidden) continue;
        float wk[VEC];
        weights<W, VEC, RESIDENT>(w, wr, i, v, wk);
#pragma unroll
        for (int k = 0; k < VEC; k += P) {
          float d[P];
#pragma unroll
          for (int e = 0; e < P; ++e)
            d[e] = __fmul_rn(to_f(gb[v].v[k + e]), wk[k + e]);
          round_p<T, P>(d);
#pragma unroll
          for (int e = 0; e < P; ++e) {
            const float xh =
                __fmul_rn(__fsub_rn(to_f(xb[v].v[k + e]), m), iv);
            p1[v] += d[e];
            p2[v] = fmaf(d[e], xh, p2[v]);
          }
          if constexpr (KEEP) put_p<T, P>(&dh[v].v[k], d);
        }
      }
      s1 += tree_sum(p1);
      s2 += tree_sum(p2);
    }
    const float c1 = rms ? 0.f : warp_sum(s1) * inv_h;
    const float c2 = warp_sum(s2) * inv_h;
    // pass 2: dx, and the column sums
    for (int c = 0; c < chunks; ++c) {
      if (!RESIDENT) {
        load_chunk<T, VEC, NV>(xr, c, hidden, lane, xb);
        load_chunk<T, VEC, NV>(gr, c, hidden, lane, gb);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = elem<VEC>(c, v, lane);
        if (i >= hidden) continue;
        float wk[VEC], qs[VEC], gs[VEC];
        if (!KEEP) weights<W, VEC, RESIDENT>(w, wr, i, v, wk);
        Vec<T, VEC> out;
#pragma unroll
        for (int k = 0; k < VEC; k += P) {
          float xh[P], xr_[P], d[P], o[P];
#pragma unroll
          for (int e = 0; e < P; ++e) {
            xh[e] = __fmul_rn(__fsub_rn(to_f(xb[v].v[k + e]), m), iv);
            xr_[e] = xh[e];
            if constexpr (KEEP)
              d[e] = to_f(dh[v].v[k + e]);
            else
              d[e] = __fmul_rn(to_f(gb[v].v[k + e]), wk[k + e]);
          }
          if constexpr (!KEEP) round_p<T, P>(d);
          if (cols) round_p<T, P>(xr_);
#pragma unroll
          for (int e = 0; e < P; ++e) {
            float t = rms ? d[e] : __fsub_rn(d[e], c1);
            t = __fsub_rn(t, __fmul_rn(xh[e], c2));
            o[e] = __fmul_rn(iv, t);
            gs[k + e] = to_f(gb[v].v[k + e]);
            qs[k + e] = __fmul_rn(gs[k + e], xr_[e]);
          }
          put_p<T, P>(&out.v[k], o);
        }
        store_vec<T, VEC>(dr + i, out);
        if (!cols) continue;
        if constexpr (RESIDENT) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            acc_s[v * VEC + k] = __fadd_rn(acc_s[v * VEC + k], qs[k]);
            acc_b[v * VEC + k] = __fadd_rn(acc_b[v * VEC + k], gs[k]);
          }
        } else {
          float a[VEC], bb[VEC];
          lds<VEC>(mine + i, a);
          lds<VEC>(mine + hidden + i, bb);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            a[k] = __fadd_rn(a[k], qs[k]);
            bb[k] = __fadd_rn(bb[k], gs[k]);
          }
          sts<VEC>(mine + i, a);
          sts<VEC>(mine + hidden + i, bb);
        }
      }
    }
  }
  if (!cols) return;
  if (RESIDENT) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = elem<VEC>(0, v, lane);
      if (i >= hidden) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        mine[i + k] = acc_s[v * VEC + k];
        mine[hidden + i + k] = acc_b[v * VEC + k];
      }
    }
  }
  __syncthreads();
  // the block's partials: its warps' sums added in warp order
  const int blocks = gridDim.x;
  for (int j = threadIdx.x; j < 2 * hidden; j += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < warps; ++v)
      s = __fadd_rn(s, sums[(size_t)v * 2 * hidden + j]);
    const int kind = j >= hidden;
    partials[((size_t)kind * blocks + blockIdx.x) * hidden + j -
             kind * hidden] = s;
  }
}

// dscale and dbias: a block takes 32 of the 2 * hidden columns, its warp v
// the partials of blocks [v * run, (v + 1) * run) (run = blocks / 8
// rounded up) added in block order, then warp 0 the warps' sums in warp
// order
template <typename W>
__global__ void __launch_bounds__(kFoldWarps * kLanes)
    ln_bwd_fold_kernel(const float* __restrict__ partials,
                       W* __restrict__ dscale, W* __restrict__ dbias,
                       int blocks, int hidden) {
  __shared__ float runs[kFoldWarps][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int j = blockIdx.x * kLanes + lane;
  const int kind = j >= hidden;
  const int run = (blocks + kFoldWarps - 1) / kFoldWarps;
  float s = 0.f;
  if (j < 2 * hidden) {
    const float* p =
        partials + (size_t)kind * blocks * hidden + j - kind * hidden;
    const int last = min(blocks, (warp + 1) * run);
#pragma unroll 16
    for (int blk = warp * run; blk < last; ++blk)
      s = __fadd_rn(s, p[(size_t)blk * hidden]);
  }
  runs[warp][lane] = s;
  __syncthreads();
  W* out = kind ? dbias : dscale;
  if (warp != 0 || j >= 2 * hidden || out == nullptr) return;
  float t = 0.f;
#pragma unroll
  for (int v = 0; v < kFoldWarps; ++v) t = __fadd_rn(t, runs[v][lane]);
  out[j - kind * hidden] = from_f<W>(t);
}

// --------------------------------------------------------------- launch
// dtype codes, as ops/layer_norm.py passes them
enum { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
constexpr int vec_of() {
  return 16 / sizeof(T);
}

template <typename T, typename W, int VEC, bool RES>
cudaError_t fwd_launch(const void* x, const void* w, const void* b, void* y,
                       float* mean, float* invvar, int rows, int hidden,
                       float eps, int rms, int warps, int grid,
                       cudaStream_t s) {
  ln_fwd_kernel<T, W, VEC, RES><<<grid, warps * kLanes, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<T*>(y), mean, invvar, rows,
      hidden, eps, rms);
  return cudaGetLastError();
}

template <typename T, typename W, int VEC, bool RES>
cudaError_t bwd_launch(const void* dy, const void* x, const void* w,
                       const float* mean, const float* invvar, void* dx,
                       float* partials, int rows, int hidden, int warps,
                       int rows_per_block, int blocks, int rms,
                       cudaStream_t s) {
  auto kernel = ln_bwd_kernel<T, W, VEC, RES>;
  const size_t smem =
      partials == nullptr ? 0 : (size_t)warps * 2 * hidden * sizeof(float);
  if (smem > 48 * 1024) {
    // once per instance and device, to the most any launch asks for
    static unsigned long long done = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (!(done >> (dev & 63) & 1)) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
      if (e != cudaSuccess) return e;
      done |= 1ull << (dev & 63);
    }
  }
  kernel<<<blocks, warps * kLanes, smem, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const W*>(w), mean, invvar, static_cast<T*>(dx), partials,
      rows, hidden, rows_per_block, rms);
  return cudaGetLastError();
}

// calls F<T, W, VEC, RESIDENT>::run(args...) for the dtype codes, the
// vector flag and hidden
template <template <typename, typename, int, bool> class F, typename T,
          typename W, typename... A>
cudaError_t by_shape(int vec, int hidden, A... args) {
  const bool res = hidden <= kChunk;
  if (vec) {
    if (res) return F<T, W, vec_of<T>(), true>::run(args...);
    return F<T, W, vec_of<T>(), false>::run(args...);
  }
  if (res) return F<T, W, 1, true>::run(args...);
  return F<T, W, 1, false>::run(args...);
}

template <template <typename, typename, int, bool> class F, typename T,
          typename... A>
cudaError_t by_weight(int w_dtype, int vec, int hidden, A... args) {
  switch (w_dtype) {
    case kF32: return by_shape<F, T, float>(vec, hidden, args...);
    case kBF16: return by_shape<F, T, bf16>(vec, hidden, args...);
    case kF16: return by_shape<F, T, fp16>(vec, hidden, args...);
  }
  return cudaErrorInvalidValue;
}

template <template <typename, typename, int, bool> class F, typename... A>
cudaError_t by_dtypes(int x_dtype, int w_dtype, int vec, int hidden,
                      A... args) {
  switch (x_dtype) {
    case kF32: return by_weight<F, float>(w_dtype, vec, hidden, args...);
    case kBF16: return by_weight<F, bf16>(w_dtype, vec, hidden, args...);
    case kF16: return by_weight<F, fp16>(w_dtype, vec, hidden, args...);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename W, int VEC, bool RES>
struct Fwd {
  template <typename... A>
  static cudaError_t run(A... args) {
    return fwd_launch<T, W, VEC, RES>(args...);
  }
};

template <typename T, typename W, int VEC, bool RES>
struct Bwd {
  template <typename... A>
  static cudaError_t run(A... args) {
    return bwd_launch<T, W, VEC, RES>(args...);
  }
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the vector instances need every row and parameter 16-byte aligned
bool vec_ok(int x_dtype, int hidden, const void* a, const void* b,
            const void* c, const void* d) {
  const int v = x_dtype == kF32 ? 4 : 8;
  return hidden % v == 0 && aligned16(a) && aligned16(b) &&
         (c == nullptr || aligned16(c)) && (d == nullptr || aligned16(d));
}

}  // namespace

extern "C" {

// x, y (rows, hidden) in x_dtype (0 fp32, 1 bf16, 2 fp16); w and b (may be
// null) (hidden,) in w_dtype; mean and invvar fp32 (rows,).  vec asks for
// the 16-byte instances (hidden a multiple of 16 bytes' worth of elements,
// every pointer 16-byte aligned); grid blocks of `warps` warps (1-8), a
// row a warp at a time.  Returns a cudaError_t code (0 = success).
int ln_fwd(const void* x, const void* w, const void* b, void* y,
           float* mean, float* invvar, int rows, int hidden, float eps,
           int rms, int x_dtype, int w_dtype, int vec, int warps, int grid,
           void* stream) {
  if (rows < 1 || hidden < 1 || grid < 1 || warps < 1 ||
      warps > kMaxWarps || x == nullptr || w == nullptr || y == nullptr ||
      mean == nullptr || invvar == nullptr)
    return cudaErrorInvalidValue;
  if (vec && !(vec_ok(x_dtype, hidden, x, y, w, b)))
    return cudaErrorInvalidValue;
  return by_dtypes<Fwd>(x_dtype, w_dtype, vec, hidden, x, w, b, y, mean,
                        invvar, rows, hidden, eps, rms, warps, grid,
                        static_cast<cudaStream_t>(stream));
}

// dy, x, dx (rows, hidden) in x_dtype; w (hidden,) in w_dtype; mean and
// invvar fp32 (rows,).  Block k of `blocks` takes rows [k * rows_per_block,
// (k + 1) * rows_per_block), its warp v of `warps` (1-8) rows v, v + warps,
// ...  partials: (2, blocks, hidden) fp32, each block's column sums of dy *
// xhat_r and of dy, or null to skip them.  Returns a cudaError_t code.
int ln_bwd(const void* dy, const void* x, const void* w, const float* mean,
           const float* invvar, void* dx, float* partials, int rows,
           int hidden, int rms, int x_dtype, int w_dtype, int vec, int warps,
           int rows_per_block, int blocks, void* stream) {
  if (rows < 1 || hidden < 1 || warps < 1 || warps > kMaxWarps ||
      rows_per_block < 1 || blocks < 1 ||
      (long long)blocks * rows_per_block < rows ||
      (long long)(blocks - 1) * rows_per_block >= rows)
    return cudaErrorInvalidValue;
  if (vec && !(vec_ok(x_dtype, hidden, dy, x, dx, w)))
    return cudaErrorInvalidValue;
  return by_dtypes<Bwd>(x_dtype, w_dtype, vec, hidden, dy, x, w, mean,
                        invvar, dx, partials, rows, hidden, warps,
                        rows_per_block, blocks, rms,
                        static_cast<cudaStream_t>(stream));
}

// partials (2, blocks, hidden) fp32 from ln_bwd; dscale and dbias (may be
// null) (hidden,) in w_dtype.  Returns a cudaError_t code.
int ln_bwd_fold(const float* partials, void* dscale, void* dbias,
                int blocks, int hidden, int w_dtype, void* stream) {
  if (blocks < 1 || hidden < 1 || partials == nullptr || dscale == nullptr)
    return cudaErrorInvalidValue;
  const int grid = (2 * hidden + kLanes - 1) / kLanes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
#define FOLD(W)                                                            \
  ln_bwd_fold_kernel<W><<<grid, kFoldWarps * kLanes, 0, s>>>(              \
      partials, static_cast<W*>(dscale), static_cast<W*>(dbias), blocks,   \
      hidden);                                                             \
  return cudaGetLastError()
    case kF32: FOLD(float);
    case kBF16: FOLD(bf16);
    case kF16: FOLD(fp16);
#undef FOLD
  }
  return cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
