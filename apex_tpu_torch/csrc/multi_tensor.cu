// Multi-tensor kernels of the optimizer tail for Hopper (sm_90a): scale
// (and axpby), the L2 norms, Adam and LAMB, each one launch over many
// tensors.
//
// They replace no Pallas kernel: the JAX package computes the tail in XLA
// (apex_tpu/multi_tensor_apply/__init__.py multi_tensor_scale :41,
// multi_tensor_axpby :84, multi_tensor_l2norm :121; the Adam update
// apex_tpu/optimizers/fused_adam.py _adam_elementwise :100; LAMB
// apex_tpu/optimizers/fused_lamb.py :101-141).  Without them the port ran
// the tail as a dozen plain PyTorch launches per parameter tensor (148
// tensors at the flagship), from a Python loop.  They are the kernels of
// the reference's amp_C (multi_tensor_scale, multi_tensor_l2norm,
// multi_tensor_adam, multi_tensor_lamb).
//
// The function, as the plain versions in ops/multi_tensor.py compute it
// (every operation rounded to fp32 on its own, in the plain version's
// order: __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, so that nvcc
// contracts nothing into an FMA the plain chain does not have):
//  scale   out = round_out(a * x) (axpby: round_out(a * x + b * y)); the
//          finite flag of the incoming x (and y).
//  l2norm  each tensor's sum of x^2 in fp32 (x first unscaled as
//          round_x(x * inv_scale) when inv_scale is given), then the sum of
//          those sums, then one sqrt; the finite flag of the incoming x.
//  adam    g = round_g(g * inv_scale) (if given), g *= clip (if given),
//          L2 (g += wd * p) or AdamW (update += wd * p) decay,
//          m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
//          update = (m / bc1) / (sqrt(v / bc2) + eps), p -= lr * update;
//          p is the fp32 master when there is one (then written back, and
//          the model-dtype parameter written rounded from it), else the
//          parameter itself; v stored in its dtype (fp32 or bf16, RNE).
//  lamb    stage 1: the same moments, u = (m / bc1) / (sqrt(v / bc2) + eps)
//          (+ wd * p), u into fp32 scratch, and each chunk's sums of p^2
//          and u^2; fold: each tensor's trust ratio |p| / |u| (1 where
//          either is 0, or without decay and NVLAMB); stage 2:
//          p -= (lr * trust) * u.
//  Adam and LAMB read a device finite flag and write nothing when it is
//  false; bc1, bc2, the clip factor and inv_scale are device scalars the
//  wrapper computes, so the kernels and the plain versions read the same
//  values.
//
// All four are bound by bytes: a few operations per element moved.  At
// the flagship (185,759,744 elements: 98 bf16 tensors with fp32 masters,
// 50 fp32 norm tensors) Adam moves 28 bytes a bf16 element and 32 an fp32
// one, 5,201,477,632 bytes, 1.553 ms at 3.35 TB/s.
//
// Design:
//  - One launch walks a table of tensors: their addresses, element counts
//    and a block -> (tensor, chunk) map travel in the kernel parameter
//    space (sm_90 with CUDA 12.1+ takes 32,764 bytes there; 4 KB tables
//    with an older toolkit), so nothing is copied to the device per step.
//    A list longer than one table takes several launches.  A chunk is
//    65,536 elements, a block 256 threads.
//  - The C entries group the tensors by their dtypes (grad, parameter,
//    second moment) and launch one template instance per group: the
//    flagship at O5 takes two launches of multi_tensor_adam.
//  - A thread moves 8 elements at a time with 16-byte vector loads where
//    every operand of the tensor is 16-byte aligned, and takes the
//    chunk's last elements one by one; a misaligned tensor goes one by
//    one.
//  - Sums are deterministic: a block reduces its chunk in a fixed order
//    into a partial, a warp adds a tensor's partials in chunk order, and
//    one warp adds the tensors' sums in tensor order.  No float atomics:
//    the same inputs give the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace {

using bf16 = __nv_bfloat16;
using fp16 = __half;

enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                 // elements a thread moves at a time
constexpr long long kChunk = 65536;     // elements a block
static_assert(kChunk % (kThreads * kVec) == 0, "chunk of whole steps");

#if CUDART_VERSION >= 12010
constexpr bool kBigParams = true;       // 32,764 bytes of kernel parameters
#else
constexpr bool kBigParams = false;      // the classic 4,096
#endif

// A table holds up to kTensors tensors of DEPTH operands and kBlocks
// blocks.
constexpr int kTensors = kBigParams ? 192 : 24;
constexpr int kBlocks = kBigParams ? 4096 : 480;

template <int DEPTH>
struct Table {
  void* ptr[DEPTH][kTensors];
  long long n[kTensors];
  int base[kTensors];         // the tensor's first chunk in the partials
  int index[kTensors];        // the tensor's place in the call's list
  unsigned char vec[kTensors];
  int block[kBlocks];         // (tensor in the table << 20) | chunk
};
static_assert(sizeof(Table<5>) <= (kBigParams ? 32000 : 3900),
              "a table fits the kernel parameter space");

// The fold's table: a tensor's first partial, its chunks, its place.
constexpr int kFoldCap = kBigParams ? 2560 : 300;
struct FoldTable {
  int base[kFoldCap];
  int chunks[kFoldCap];
  int index[kFoldCap];
};

// ---------------------------------------------------------- element I/O
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(fp16 x) { return __half2float(x); }

template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ fp16 from_f<fp16>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back (round to nearest even)
template <class T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// W elements at p into r: W = 8 as 16-byte vectors (p 16-byte aligned),
// W = 1 one by one
template <int W, class T>
__device__ __forceinline__ void ld(const T* p, float (&r)[W]) {
  if constexpr (W == kVec) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
      r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
    } else {
      alignas(16) T h[kVec];
      *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int k = 0; k < kVec; ++k) r[k] = to_f(h[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) r[k] = to_f(p[k]);
  }
}

template <int W, class T>
__device__ __forceinline__ void st(T* p, const float (&r)[W]) {
  if constexpr (W == kVec) {
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
    } else {
      alignas(16) T h[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) h[k] = from_f<T>(r[k]);
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) p[k] = from_f<T>(r[k]);
  }
}

// The block's chunk: its tensor in the table, and [start, end).
template <int DEPTH>
struct Span {
  int t;
  long long start, end;
  __device__ __forceinline__ explicit Span(const Table<DEPTH>& tab) {
    const int code = tab.block[blockIdx.x];
    t = code >> 20;
    start = static_cast<long long>(code & 0xFFFFF) * kChunk;
    const long long stop = start + kChunk;
    end = stop < tab.n[t] ? stop : tab.n[t];
  }
};

// f.template run<W>(i) over the span: groups of 8 from the start where the
// tensor is aligned, then the rest one by one.
template <class F>
__device__ __forceinline__ void walk(long long start, long long end,
                                     bool vec, F& f) {
  long long rest = start;
  if (vec) {
    rest = start + (end - start) / kVec * kVec;
    for (long long i = start + threadIdx.x * kVec; i < rest;
         i += kThreads * kVec)
      f.template run<kVec>(i);
  }
  for (long long i = rest + threadIdx.x; i < end; i += kThreads)
    f.template run<1>(i);
}

// The block's sum of x, in a fixed order, in thread 0.
__device__ __forceinline__ float block_sum(float x, float* smem) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[w];
  }
  __syncthreads();
  return s;
}

// A warp's sum of x, in a fixed order, in every lane.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool is_finite(float x) { return isfinite(x); }

// --------------------------------------------------------------- scale
// MODE 0: check x only; 1: out = a * x; 2: out = a * x + b * y.
struct ScaleArgs {
  const float* a_ptr;       // a device scalar in place of a (may be null)
  const float* b_ptr;
  float a, b;
  unsigned char* finite;    // set to 0 where an incoming value is not finite
};

template <int MODE, class X, class Y, class O>
struct ScaleOp {
  const X* x;
  const Y* y;
  O* out;
  float a, b;
  bool bad;
  template <int W>
  __device__ __forceinline__ void run(long long i) {
    float xr[W];
    ld<W>(x + i, xr);
#pragma unroll
    for (int k = 0; k < W; ++k) bad |= !is_finite(xr[k]);
    if constexpr (MODE == 2) {
      float yr[W], o[W];
      ld<W>(y + i, yr);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        bad |= !is_finite(yr[k]);
        o[k] = __fadd_rn(__fmul_rn(a, xr[k]), __fmul_rn(b, yr[k]));
      }
      st<W>(out + i, o);
    } else if constexpr (MODE == 1) {
      float o[W];
#pragma unroll
      for (int k = 0; k < W; ++k) o[k] = __fmul_rn(xr[k], a);
      st<W>(out + i, o);
    }
  }
};

template <int MODE, class X, class Y, class O>
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const Table<3> tab, const ScaleArgs args) {
  const Span<3> s(tab);
  ScaleOp<MODE, X, Y, O> op;
  op.x = static_cast<const X*>(tab.ptr[0][s.t]);
  op.y = static_cast<const Y*>(tab.ptr[1][s.t]);
  op.out = static_cast<O*>(tab.ptr[2][s.t]);
  op.a = args.a_ptr ? *args.a_ptr : args.a;
  op.b = args.b_ptr ? *args.b_ptr : args.b;
  op.bad = false;
  walk(s.start, s.end, tab.vec[s.t], op);
  if (op.bad && args.finite) *args.finite = 0;
}

// -------------------------------------------------------------- l2norm
struct NormArgs {
  const float* inv_scale;   // unscale before squaring (may be null)
  float* partials;          // a sum of squares a chunk
  unsigned char* finite;    // may be null
};

template <class X>
struct NormOp {
  const X* x;
  float inv;
  bool unscale, bad;
  float acc;
  template <int W>
  __device__ __forceinline__ void run(long long i) {
    float xr[W];
    ld<W>(x + i, xr);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      bad |= !is_finite(xr[k]);
      const float v = unscale ? round_to<X>(__fmul_rn(xr[k], inv)) : xr[k];
      acc = fmaf(v, v, acc);
    }
  }
};

template <class X>
__global__ void __launch_bounds__(kThreads)
    l2norm_kernel(const Table<1> tab, const NormArgs args) {
  __shared__ float smem[kWarps];
  const Span<1> s(tab);
  NormOp<X> op;
  op.x = static_cast<const X*>(tab.ptr[0][s.t]);
  op.unscale = args.inv_scale != nullptr;
  op.inv = op.unscale ? *args.inv_scale : 1.f;
  op.bad = false;
  op.acc = 0.f;
  walk(s.start, s.end, tab.vec[s.t], op);
  if (op.bad && args.finite) *args.finite = 0;
  const float sum = block_sum(op.acc, smem);
  if (threadIdx.x == 0)
    args.partials[tab.base[s.t] + (tab.block[blockIdx.x] & 0xFFFFF)] = sum;
}

// Each tensor's sum of its chunks' partials (a warp a tensor): l2norm's
// sums of squares and norms, or LAMB's trust ratios.
struct FoldArgs {
  const float* partials;    // l2norm: one a chunk; LAMB: two (p^2, u^2)
  float* sq;                // l2norm: each tensor's sum of squares
  float* norms;             // l2norm: each tensor's norm (may be null)
  float* trust;             // LAMB: each tensor's trust ratio
  const unsigned char* finite;  // LAMB: skip on a false flag
  int use_trust;            // LAMB: 0 gives every tensor a ratio of 1
};

template <int NSUM>
__global__ void __launch_bounds__(32)
    fold_kernel(const FoldTable tab, const FoldArgs args) {
  if (NSUM == 2 && args.finite && !*args.finite) return;
  const int t = blockIdx.x;
  const float* p = args.partials + static_cast<long long>(NSUM) * tab.base[t];
  float s0 = 0.f, s1 = 0.f;
  for (int c = threadIdx.x; c < tab.chunks[t]; c += 32) {
    s0 += p[NSUM * c];
    if (NSUM == 2) s1 += p[NSUM * c + 1];
  }
  s0 = warp_sum(s0);
  if (NSUM == 2) s1 = warp_sum(s1);
  if (threadIdx.x != 0) return;
  const int i = tab.index[t];
  if (NSUM == 1) {
    args.sq[i] = s0;
    if (args.norms) args.norms[i] = __fsqrt_rn(s0);
  } else {
    const float w = __fsqrt_rn(s0), u = __fsqrt_rn(s1);
    args.trust[i] = (!args.use_trust || !(w > 0.f && u > 0.f))
                        ? 1.f : __fdiv_rn(w, u);
  }
}

// The tensors' sums of squares added in order, and one sqrt.
__global__ void __launch_bounds__(32)
    l2norm_total_kernel(const float* sq, int n, float* total) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += 32) s += sq[i];
  s = warp_sum(s);
  if (threadIdx.x == 0) *total = __fsqrt_rn(s);
}


// ------------------------------------------------------------ adam/lamb
struct StepArgs {
  const float* clip;        // the clip factor (may be null: none)
  const float* inv_scale;   // the loss scaler's 1 / scale (may be null)
  const float* bc1;         // 1 - b1^step (may be null: 1)
  const float* bc2;         // 1 - b2^step (may be null: 1)
  const unsigned char* finite;  // no write at all when 0 (may be null)
  float* partials;          // LAMB stage 1: (p^2, u^2) a chunk
  const float* trust;       // LAMB stage 2: a ratio a tensor
  float b1, b2, c1, omb2;   // c1: Adam's 1 - b1, LAMB's beta3
  float eps, lr, wd;
  int adam_w;               // AdamW (1) or L2 (0) decay
};

// STAGE 0, Adam: operands (grad, parameter, fp32 master, exp_avg,
// exp_avg_sq); the fp32 work parameter is the master where MASTER, else
// the parameter.  STAGE 1, LAMB's moments: (grad, work parameter (the
// master as an fp32 P), u, exp_avg, exp_avg_sq).  STAGE 2, LAMB's
// update: (u, parameter, fp32 master).
template <int STAGE, class G, class P, class V, bool MASTER>
struct StepOp {
  const G* g;
  P* p;
  float* master;
  float* m;
  V* v;
  float* u;
  float inv, clip, bc1, bc2, step;
  bool unscale, clipped;
  StepArgs a;
  float acc_p, acc_u;

  template <int W>
  __device__ __forceinline__ void run(long long i) {
    float pw[W];
    if constexpr (MASTER) ld<W>(master + i, pw);
    else ld<W>(p + i, pw);
    if constexpr (STAGE == 2) {
      float ur[W];
      ld<W>(u + i, ur);
#pragma unroll
      for (int k = 0; k < W; ++k)
        pw[k] = __fsub_rn(pw[k], __fmul_rn(step, ur[k]));
      if constexpr (MASTER) st<W>(master + i, pw);
      st<W>(p + i, pw);
    } else {
      float gr[W], mr[W], vr[W], out[W];
      ld<W>(g + i, gr);
      ld<W>(m + i, mr);
      ld<W>(v + i, vr);
      const bool decays = a.wd != 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        float gk = gr[k];
        if (unscale) gk = round_to<G>(__fmul_rn(gk, inv));
        if (clipped) gk = __fmul_rn(gk, clip);
        const float decay = __fmul_rn(a.wd, pw[k]);
        if (decays && !a.adam_w) gk = __fadd_rn(gk, decay);
        mr[k] = __fadd_rn(__fmul_rn(a.b1, mr[k]), __fmul_rn(a.c1, gk));
        vr[k] = __fadd_rn(__fmul_rn(a.b2, vr[k]),
                          __fmul_rn(a.omb2, __fmul_rn(gk, gk)));
        const float denom =
            __fadd_rn(__fsqrt_rn(__fdiv_rn(vr[k], bc2)), a.eps);
        float upd = __fdiv_rn(__fdiv_rn(mr[k], bc1), denom);
        if (decays && a.adam_w) upd = __fadd_rn(upd, decay);
        if constexpr (STAGE == 0) {
          out[k] = __fsub_rn(pw[k], __fmul_rn(a.lr, upd));
        } else {
          out[k] = upd;
          acc_p = fmaf(pw[k], pw[k], acc_p);
          acc_u = fmaf(upd, upd, acc_u);
        }
      }
      st<W>(m + i, mr);
      st<W>(v + i, vr);
      if constexpr (STAGE == 0) {
        if constexpr (MASTER) st<W>(master + i, out);
        st<W>(p + i, out);
      } else {
        st<W>(u + i, out);
      }
    }
  }
};

template <int STAGE, class G, class P, class V, bool MASTER>
__global__ void __launch_bounds__(kThreads)
    step_kernel(const Table<5> tab, const StepArgs args) {
  __shared__ float smem[kWarps];
  if (args.finite && !*args.finite) return;
  const Span<5> s(tab);
  StepOp<STAGE, G, P, V, MASTER> op;
  if constexpr (STAGE == 2) {
    op.u = static_cast<float*>(tab.ptr[0][s.t]);
    op.p = static_cast<P*>(tab.ptr[1][s.t]);
    op.master = static_cast<float*>(tab.ptr[2][s.t]);
    op.step = __fmul_rn(args.lr, args.trust[tab.index[s.t]]);
  } else {
    op.g = static_cast<const G*>(tab.ptr[0][s.t]);
    op.p = static_cast<P*>(tab.ptr[1][s.t]);
    if constexpr (STAGE == 0)
      op.master = static_cast<float*>(tab.ptr[2][s.t]);
    else
      op.u = static_cast<float*>(tab.ptr[2][s.t]);
    op.m = static_cast<float*>(tab.ptr[3][s.t]);
    op.v = static_cast<V*>(tab.ptr[4][s.t]);
    op.unscale = args.inv_scale != nullptr;
    op.inv = op.unscale ? *args.inv_scale : 1.f;
    op.clipped = args.clip != nullptr;
    op.clip = op.clipped ? *args.clip : 1.f;
    op.bc1 = args.bc1 ? *args.bc1 : 1.f;
    op.bc2 = args.bc2 ? *args.bc2 : 1.f;
  }
  op.a = args;
  op.acc_p = op.acc_u = 0.f;
  walk(s.start, s.end, tab.vec[s.t], op);
  if constexpr (STAGE == 1) {
    const float sp = block_sum(op.acc_p, smem);
    const float su = block_sum(op.acc_u, smem);
    if (threadIdx.x == 0) {
      const long long c = tab.base[s.t] + (tab.block[blockIdx.x] & 0xFFFFF);
      args.partials[2 * c] = sp;
      args.partials[2 * c + 1] = su;
    }
  }
}

// --------------------------------------------------------------- host
bool aligned16(long long p) { return p % 16 == 0; }

long long chunks_of(long long n) { return (n + kChunk - 1) / kChunk; }

// Fill tables with the tensors i of the list that pick(i) selects and
// call launch(table, blocks) for each full table and the last.  Operand
// d of tensor i is rows[i * stride + col[d]] (null where col[d] < 0); a
// tensor takes the vector path when all its operands are 16-byte
// aligned.  base (may be null): each tensor's first chunk in the
// partials.  Returns the first launch error.
template <int DEPTH, class Pick, class Launch>
cudaError_t for_tables(const long long* rows, int stride, const int* col,
                       const long long* sizes, const int* base, int n,
                       Pick pick, Launch launch) {
  // the host copy, passed by value to each launch (its parameters are
  // copied when the launch is issued)
  thread_local Table<DEPTH> tab;
  int nt = 0, nb = 0;
  auto flush = [&]() -> cudaError_t {
    cudaError_t err = cudaSuccess;
    if (nb > 0) err = launch(tab, nb);
    nt = nb = 0;
    return err;
  };
  for (int i = 0; i < n; ++i) {
    if (sizes[i] <= 0 || !pick(i)) continue;
    bool vec = true;
    for (int d = 0; d < DEPTH; ++d)
      vec = vec && (col[d] < 0 || aligned16(rows[i * stride + col[d]]));
    const long long chunks = chunks_of(sizes[i]);
    for (long long c = 0; c < chunks; ++c) {
      if (c == 0 || nt == 0) {
        if (nt == kTensors) {
          const cudaError_t err = flush();
          if (err != cudaSuccess) return err;
        }
        for (int d = 0; d < DEPTH; ++d)
          tab.ptr[d][nt] = col[d] < 0 ? nullptr
              : reinterpret_cast<void*>(rows[i * stride + col[d]]);
        tab.n[nt] = sizes[i];
        tab.base[nt] = base ? base[i] : 0;
        tab.index[nt] = i;
        tab.vec[nt] = vec;
        ++nt;
      }
      tab.block[nb++] = ((nt - 1) << 20) | static_cast<int>(c);
      if (nb == kBlocks) {
        const cudaError_t err = flush();
        if (err != cudaSuccess) return err;
      }
    }
  }
  return flush();
}

// Each tensor's first chunk in the partials (prefix sums of the chunk
// counts); returns the total.
long long chunk_bases(const long long* sizes, int n, std::vector<int>& base) {
  long long total = 0;
  base.assign(n, 0);
  for (int i = 0; i < n; ++i) {
    base[i] = static_cast<int>(total);
    total += sizes[i] > 0 ? chunks_of(sizes[i]) : 0;
  }
  return total;
}

template <int NSUM>
cudaError_t fold(const long long* sizes, const std::vector<int>& base,
                 int n, const FoldArgs& args, cudaStream_t stream) {
  thread_local FoldTable tab;
  int k = 0;
  for (int i = 0; i <= n; ++i) {
    if (k == kFoldCap || (i == n && k > 0)) {
      fold_kernel<NSUM><<<k, 32, 0, stream>>>(tab, args);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      k = 0;
    }
    if (i == n) break;
    if (sizes[i] <= 0) continue;
    tab.base[k] = base[i];
    tab.chunks[k] = static_cast<int>(chunks_of(sizes[i]));
    tab.index[k] = i;
    ++k;
  }
  return cudaSuccess;
}

bool dtype_ok(int d) { return d == kF32 || d == kBF16 || d == kF16; }

// f(T{}) with T the type of dtype code d
template <class F>
cudaError_t by_dtype(int d, F f) {
  switch (d) {
    case kF32: return f(float{});
    case kBF16: return f(bf16{});
    case kF16: return f(fp16{});
  }
  return cudaErrorInvalidValue;
}

// f(G{}, P{}, V{}) for each (grad, parameter, exp_avg_sq) dtype triple
// present in dtypes (n x 3), with pick(i) selecting the triple's rows
template <class F>
cudaError_t by_triple(const int* dtypes, int n, F f) {
  for (int dg = 0; dg < 3; ++dg)
    for (int dp = 0; dp < 3; ++dp)
      for (int dv = 0; dv < 2; ++dv) {
        bool any = false;
        for (int i = 0; i < n && !any; ++i)
          any = dtypes[3 * i] == dg && dtypes[3 * i + 1] == dp &&
                dtypes[3 * i + 2] == dv;
        if (!any) continue;
        auto pick = [=](int i) {
          return dtypes[3 * i] == dg && dtypes[3 * i + 1] == dp &&
                 dtypes[3 * i + 2] == dv;
        };
        const cudaError_t err = by_dtype(dg, [&](auto g) {
          return by_dtype(dp, [&](auto p) {
            return by_dtype(dv, [&](auto v) { return f(g, p, v, pick); });
          });
        });
        if (err != cudaSuccess) return err;
      }
  return cudaSuccess;
}

// every row's dtypes are ones the step kernels take, and a row with
// elements has its master where there are masters
bool step_rows_ok(const long long* ptrs, const long long* sizes,
                  const int* dtypes, int n, int master) {
  for (int i = 0; i < n; ++i)
    if (!dtype_ok(dtypes[3 * i]) || !dtype_ok(dtypes[3 * i + 1]) ||
        (dtypes[3 * i + 2] != kF32 && dtypes[3 * i + 2] != kBF16) ||
        (master && sizes[i] > 0 && ptrs[5 * i + 2] == 0))
      return false;
  return true;
}

}  // namespace

extern "C" {

// mode 0: check x (rows of ptrs n x 3: x, y, out; y and out unused);
// 1: out = a * x; 2: out = a * x + b * y.  dtypes n x 3 (0 fp32, 1 bf16,
// 2 fp16) of x, y, out.  a_ptr / b_ptr (may be null): device fp32
// scalars read in place of a / b.  finite (may be null): a device byte
// the kernel sets to 0 where an incoming x or y is not finite.  Returns a
// cudaError_t code (0 = success).
int multi_tensor_scale(const long long* ptrs, const long long* sizes,
                       const int* dtypes, int n, int mode,
                       const float* a_ptr, const float* b_ptr, float a,
                       float b, unsigned char* finite, void* stream) {
  if (n < 0 || mode < 0 || mode > 2 ||
      (n > 0 && (!ptrs || !sizes || !dtypes)))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 3 * n; ++i)
    if (!dtype_ok(dtypes[i])) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScaleArgs args{a_ptr, b_ptr, a, b, finite};
  const int cols[3][3] = {{0, -1, -1}, {0, -1, 2}, {0, 1, 2}};
  for (int dx = 0; dx < 3; ++dx)
    for (int dy = 0; dy < (mode == 2 ? 3 : 1); ++dy)
      for (int dout = 0; dout < (mode > 0 ? 3 : 1); ++dout) {
        auto pick = [&](int i) {
          return dtypes[3 * i] == dx &&
                 (mode < 2 || dtypes[3 * i + 1] == dy) &&
                 (mode == 0 || dtypes[3 * i + 2] == dout);
        };
        const cudaError_t err = by_dtype(dx, [&](auto x) {
          return by_dtype(dy, [&](auto y) {
            return by_dtype(dout, [&](auto o) {
              using X = decltype(x);
              using Y = decltype(y);
              using O = decltype(o);
              return for_tables<3>(
                  ptrs, 3, cols[mode], sizes, nullptr, n, pick,
                  [&](const Table<3>& tab, int blocks) {
                    if (mode == 0)
                      scale_kernel<0, X, X, X>
                          <<<blocks, kThreads, 0, s>>>(tab, args);
                    else if (mode == 1)
                      scale_kernel<1, X, X, O>
                          <<<blocks, kThreads, 0, s>>>(tab, args);
                    else
                      scale_kernel<2, X, Y, O>
                          <<<blocks, kThreads, 0, s>>>(tab, args);
                    return cudaGetLastError();
                  });
            });
          });
        });
        if (err != cudaSuccess) return err;
      }
  return cudaSuccess;
}

// x: n tensors (ptrs, sizes, dtypes each n).  inv_scale (may be null):
// square round_x(x * inv_scale).  partials: fp32 scratch, one float a
// chunk of 65,536 elements over all tensors; sq: n fp32 zero-filled by
// the caller, each tensor's sum of squares; norms (may be null): n fp32,
// each tensor's norm; total (may be null): the global norm; finite (may
// be null): a device byte set to 0 where an x is not finite.  Returns a
// cudaError_t code.
int multi_tensor_l2norm(const long long* ptrs, const long long* sizes,
                        const int* dtypes, int n, const float* inv_scale,
                        float* partials, float* sq, float* norms,
                        float* total, unsigned char* finite, void* stream) {
  if (n < 0 || (n > 0 && (!ptrs || !sizes || !dtypes || !sq)))
    return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i)
    if (!dtype_ok(dtypes[i])) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::vector<int> base;
  if (chunk_bases(sizes, n, base) > 0 && !partials)
    return cudaErrorInvalidValue;
  const NormArgs args{inv_scale, partials, finite};
  const int cols[1] = {0};
  for (int dx = 0; dx < 3; ++dx) {
    const cudaError_t err = by_dtype(dx, [&](auto x) {
      using X = decltype(x);
      return for_tables<1>(
          ptrs, 1, cols, sizes, base.data(), n,
          [&](int i) { return dtypes[i] == dx; },
          [&](const Table<1>& tab, int blocks) {
            l2norm_kernel<X><<<blocks, kThreads, 0, s>>>(tab, args);
            return cudaGetLastError();
          });
    });
    if (err != cudaSuccess) return err;
  }
  FoldArgs fargs{};
  fargs.partials = partials;
  fargs.sq = sq;
  fargs.norms = norms;
  cudaError_t err = fold<1>(sizes, base, n, fargs, s);
  if (err != cudaSuccess || !total) return err;
  l2norm_total_kernel<<<1, 32, 0, s>>>(sq, n, total);
  return cudaGetLastError();
}

// Adam over n rows of ptrs (n x 5: grad, parameter, fp32 master (0
// without masters), exp_avg (fp32), exp_avg_sq) of sizes[i] elements;
// dtypes n x 3 (grad, parameter, exp_avg_sq; the last fp32 or bf16).
// clip, inv_scale, bc1, bc2 (each may be null) are device fp32 scalars;
// finite (may be null) a device byte whose 0 skips the whole update.
// c1 = 1 - b1, omb2 = 1 - b2.  Returns a cudaError_t code.
int multi_tensor_adam(const long long* ptrs, const long long* sizes,
                      const int* dtypes, int n, int master,
                      const float* clip, const float* inv_scale,
                      const float* bc1, const float* bc2,
                      const unsigned char* finite, float b1, float b2,
                      float c1, float omb2, float eps, float lr, float wd,
                      int adam_w, void* stream) {
  if (n < 0 || (n > 0 && (!ptrs || !sizes || !dtypes)) ||
      !step_rows_ok(ptrs, sizes, dtypes, n, master))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StepArgs args{clip, inv_scale, bc1, bc2, finite, nullptr, nullptr,
                      b1, b2, c1, omb2, eps, lr, wd, adam_w};
  const int cols_master[5] = {0, 1, 2, 3, 4};
  const int cols[5] = {0, 1, -1, 3, 4};
  return by_triple(dtypes, n, [&](auto g, auto p, auto v, auto pick) {
    using G = decltype(g);
    using P = decltype(p);
    using V = decltype(v);
    return for_tables<5>(
        ptrs, 5, master ? cols_master : cols, sizes, nullptr, n, pick,
        [&](const Table<5>& tab, int blocks) {
          if (master)
            step_kernel<0, G, P, V, true>
                <<<blocks, kThreads, 0, s>>>(tab, args);
          else
            step_kernel<0, G, P, V, false>
                <<<blocks, kThreads, 0, s>>>(tab, args);
          return cudaGetLastError();
        });
  });
}

// LAMB over n rows of ptrs (n x 5, as multi_tensor_adam's) in two stages:
// the moments and u (fp32 scratch: tensor i at element offset u_off[i], a
// multiple of 8) with each chunk's sums of p^2 and u^2 (partials: two fp32
// a chunk), the fold into trust (n fp32), then p -= (lr * trust) * u.
// use_trust 0 sets every ratio to 1; c1 is beta3 (1 - b1 with grad
// averaging, else 1).  Returns a cudaError_t code.
int multi_tensor_lamb(const long long* ptrs, const long long* sizes,
                      const int* dtypes, int n, int master,
                      const float* clip, const float* inv_scale,
                      const float* bc1, const float* bc2,
                      const unsigned char* finite, float* u,
                      const long long* u_off, float* partials, float* trust,
                      float b1, float b2, float c1, float omb2, float eps,
                      float lr, float wd, int adam_w, int use_trust,
                      void* stream) {
  if (n < 0 || (n > 0 && (!ptrs || !sizes || !dtypes || !u_off || !trust)) ||
      !step_rows_ok(ptrs, sizes, dtypes, n, master))
    return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i)
    if (u_off[i] % kVec != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::vector<int> base;
  if (chunk_bases(sizes, n, base) > 0 && (!partials || !u))
    return cudaErrorInvalidValue;
  StepArgs args{clip, inv_scale, bc1, bc2, finite, partials, trust,
                b1, b2, c1, omb2, eps, lr, wd, adam_w};
  // stage 1: (grad, work parameter, u, exp_avg, exp_avg_sq), the master
  // standing in for the parameter as an fp32 one
  std::vector<long long> rows(ptrs, ptrs + 5 * static_cast<size_t>(n));
  std::vector<int> types(dtypes, dtypes + 3 * static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    rows[5 * i + 2] = reinterpret_cast<long long>(u + u_off[i]);
    if (master) {
      rows[5 * i + 1] = ptrs[5 * i + 2];
      types[3 * i + 1] = kF32;
    }
  }
  const int cols[5] = {0, 1, 2, 3, 4};
  cudaError_t err = by_triple(
      types.data(), n, [&](auto g, auto p, auto v, auto pick) {
        using G = decltype(g);
        using P = decltype(p);
        using V = decltype(v);
        return for_tables<5>(
            rows.data(), 5, cols, sizes, base.data(), n, pick,
            [&](const Table<5>& tab, int blocks) {
              step_kernel<1, G, P, V, false>
                  <<<blocks, kThreads, 0, s>>>(tab, args);
              return cudaGetLastError();
            });
      });
  if (err != cudaSuccess) return err;
  FoldArgs fargs{};
  fargs.partials = partials;
  fargs.trust = trust;
  fargs.finite = finite;
  fargs.use_trust = use_trust;
  err = fold<2>(sizes, base, n, fargs, s);
  if (err != cudaSuccess) return err;
  // stage 2: (u, parameter, master)
  for (int i = 0; i < n; ++i) {
    rows[5 * i] = reinterpret_cast<long long>(u + u_off[i]);
    rows[5 * i + 1] = ptrs[5 * i + 1];
    rows[5 * i + 2] = master ? ptrs[5 * i + 2] : 0;
  }
  const int cols2[5] = {0, 1, master ? 2 : -1, -1, -1};
  for (int dp = 0; dp < 3; ++dp) {
    err = by_dtype(dp, [&](auto p) {
      using P = decltype(p);
      return for_tables<5>(
          rows.data(), 5, cols2, sizes, nullptr, n,
          [&](int i) { return dtypes[3 * i + 1] == dp; },
          [&](const Table<5>& tab, int blocks) {
            if (master)
              step_kernel<2, float, P, float, true>
                  <<<blocks, kThreads, 0, s>>>(tab, args);
            else
              step_kernel<2, float, P, float, false>
                  <<<blocks, kThreads, 0, s>>>(tab, args);
            return cudaGetLastError();
          });
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
