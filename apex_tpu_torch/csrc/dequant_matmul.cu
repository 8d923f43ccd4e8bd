// Weight-dequantizing matmul for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/dequant_matmul.py::_int8_kernel (:97) and
// _int4_kernel (:107), the Pallas TPU kernels behind dequant_matmul:
// out (m, n) = x (m, k) @ dequant(W), with W stored block-quantized along
// the output features:
//  - int8: q (k, n) int8, scales (k, n / block) fp32;
//  - int4: q (k, n / 2) packed bytes in the halves layout: packed column
//    c holds output column c in its low nibble and column c + n/2 in its
//    high nibble, each sign-extended by ((x & 0xF) ^ 8) - 8; scales
//    (k, n / block) as for int8, so column c's scale is scales[r, c/block]
//    in either half.
// The function is the Pallas bodies': each weight element is dequantized
// in fp32 with the scale of its own (k row, n block), w = float(q) * s,
// the products with x are summed in fp32 and the result is rounded once
// to x's dtype.  The scale belongs to (k, n / block), so it cannot be
// taken out of the k-sum: dequantizing costs one multiply per weight.
//
// Translation from the TPU kernels:
//  - The Pallas kernel holds the whole x (m, k) in VMEM and walks
//    output-column tiles sized by a VMEM budget (_pick_bn).  Here x is
//    tiled too (at a 2304-token prefill x is 4.7 MB in bf16) and k is
//    walked inside the block, or split across blocks.
//  - The int4 kernel's (2, m, n/2) output slabs and the concatenation
//    after it exist for the TPU's lane layout.  Here each packed byte
//    gives columns c and c + n/2, and the kernels write both straight into
//    (m, n).  Every block owns 128 output features: int8 columns
//    [n0, n0 + 128); int4 the packed columns [p0, p0 + 64), i.e. features
//    [p0, p0 + 64) and [p0 + n/2, p0 + n/2 + 64).
//
// Three kernels; the wrapper (ops/dequant_matmul.py, dequant_plan) picks
// one from m and x's dtype and computes the grid, the k split and the
// scratch from the shapes alone, so a call can be captured in a CUDA
// graph:
//  - decode (m <= 8, the serving slots), dequant_decode: bound by the
//    weight bytes (int8 3.1 MB for the flagship's qkv, int4 half), not by
//    the products, so the arithmetic stays fp32 on the CUDA cores.  A
//    block of 256 threads owns 128 features and a k slice of up to 1024
//    rows; the plan splits k into floor(132 / feature tiles) slices (4-16
//    for the flagship, one block an SM).  The block streams its weight
//    rows and their scales through a cp.async ring of 4 stages of 64 k
//    rows (8 KB of int8 a stage, three in flight); its x slice lands with the first stage and is
//    widened to fp32 once.  Warp w takes rows w, w + 8, ..., lane l four
//    features of a row (one 4- or 2-byte load); the weights become floats
//    by exact bit tricks (a byte or nibble in the mantissa of 2^23), not
//    by conversion instructions.  The eight warps' sums meet in shared
//    memory and are added by a fixed pairwise tree.  On an H100 a call
//    takes 5.5-9 us (PERF.md), about the old two launches: the critical
//    path is serial round trips (the stream's first bytes, the ticket, the
//    merge's reads), not bandwidth.
//  - prefill with bf16 x (m > 8), dequant_wgmma: bound by the products
//    (2mkn, 19 GFLOP for fc2 at m = 2304), which the CUDA cores' fp32 rate
//    (67 TFLOP/s) cannot reach; the tensor cores take bf16 operands only,
//    and a bf16 (or TF32) weight would round every w to 8 (11) bits,
//    another function.  So each dequantized fp32 weight is split,
//    w_hi = bf16(w), w_lo = bf16(w - w_hi) (w - w_hi is exact in fp32),
//    and two bf16 passes x.w_hi + x.w_lo accumulate in fp32: x in bf16
//    and every q are exact, the products are exact in the fp32
//    accumulator, and w_hi + w_lo carries w to about 2^-16 relative, so
//    the sum differs from the fp32 kernel's by far less than one bf16 ulp
//    before the one rounding.  The kernel computes the transpose,
//    out^T = W^T . x^T: the dequantized weights are wgmma's A operand,
//    made in registers (RS form), so they never pass through shared
//    memory; a warpgroup's 64 A rows are output features; the tokens are
//    wgmma's N, a tile of 32, 64, 128, 144 or 256 (m pads to the tile, not
//    to 128).  TMA brings the x tile (128-byte swizzle, B K-major) and the
//    raw int8 (128-byte swizzle) or packed int4 (64-byte swizzle) tile of
//    64 k rows into a ring of 4 stages under mbarriers; one thread of a
//    producer warpgroup issues them (setmaxnreg 24/240).  Two consumer
//    warpgroups own 64 features each (int4: the low and the high nibbles
//    of the same 64 packed columns).  A warpgroup builds the A fragments
//    of a whole 64-row slab (4 k steps, hi and lo) while the previous
//    slab's 8 products run, then issues the slab's products back to back:
//    built one step ahead, the dequantization and the products ran one
//    after the other.  A thread's two A rows are made the adjacent
//    features 2j and 2j + 1, so it reads both weights of a k row with one
//    2-byte load (the swizzle keeps the quad's four rows in different
//    banks) and stores a bf16 pair: each warp store fills four whole
//    32-byte sectors, so the epilogue stores from registers.  The scales
//    are read from global memory two slabs ahead.  The dequantization is
//    redone by every token tile of a feature tile, so the plan weighs
//    waves against tile width (a cost model fitted on the card: fc2 at
//    m = 2304 in one wave of 8 x 16 tiles of 144 tokens, qkv in two waves
//    of 256).
//  - prefill with fp16 x (the opt levels O1-O3): the same kernel on
//    .f32.f16.f16 products, each weight split into fp16 hi + lo.  fp16
//    keeps 3 more bits of mantissa than bf16 but 3 fewer of exponent,
//    and w - fp16(w) (about |w| 2^-12) of a typical
//    weight (|w| ~ 0.02) falls in fp16's subnormals (below 2^-14) and
//    loses its bits.  So each feature's weights are scaled by a power of
//    two 2^e first, chosen from the largest scale of the feature's
//    column over the split's k rows (the block scans them before it
//    starts: kc reads a column) so that the largest |w| 2^e lies in
//    [2^14, 2^15): no w 2^e overflows, and the hi and lo parts of every
//    weight within 2^-24 of the largest stay normal.  2^e is folded into
//    the scales (exact), and the fp32 sums are multiplied by 2^-e
//    (exact) before the one rounding, so the function is unchanged.
//    The tensor cores add products into their fp32 accumulator with
//    truncation, a bias that grows with the number of products a sum
//    takes: harmless at bf16's ulp, it put 3.2% of the fp16 outputs one
//    ulp off the plain version at k = 4096 (1% at k = 1024; measured on
//    an H100).  So each group of 4 k steps (a slab) starts a fresh sum
//    (wgmma's scale-d 0) and the groups' sums are added in fp32 on the
//    CUDA cores, after a wait for the group's products.  The second set
//    of sums holds N / 2 registers more, so the fp16 tiles stop at 64
//    tokens.
//  - fp32 x (m > 8), dequant_tiled: exact fp32 on the CUDA cores (the
//    parity phases and tests; fp32 has no tensor-core form that keeps
//    it), 128 x 128 output tiles, k in steps of 32, each thread an 8 x 8
//    sub-tile, the weight tile dequantized on its way into shared memory.
//    bf16 x with int4 weights whose n / 2 is not a multiple of 16 (TMA
//    needs 16-byte row strides; no flagship projection) takes it too; bf16
//    x over int8 weights never does (no such instance).
//
// A k split: each block writes its fp32 partial tile to a workspace
// (splits, m, n), and the last block of an output tile adds the splits
// in split order 0, 1, ... and rounds once.  It finds out it is last by
// an atomicAdd ticket on an int32 counter, taken by one thread after a
// block barrier and a __threadfence(); the wrapper keeps the counters
// zeroed per (device, stream) and the last block resets its own: one
// launch a call, no memset, no floating-point atomics, the same bits on
// every call.  With one split a block stores its output directly and
// touches no workspace.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kThreads = 256;
constexpr int kDecodeMaxM = 8;        // rows the decode kernel takes
constexpr int kDecodeStages = 4;      // decode ring stages, three in flight
constexpr int kDecodeRows = 64;       // k rows of a decode ring stage
constexpr int kDecodeMaxKc = 1024;    // k rows of a decode block (x slice)
constexpr int BM = 128, BN = 128, BK = 32;   // fp32 prefill tiles
constexpr int kWgK = 64;              // k rows of a wgmma slab
constexpr int kWgStages = 4;          // slabs in the wgmma ring
constexpr int kWgThreads = 384;       // two consumer warpgroups, a producer
constexpr int kWgGroup = 4;           // k steps whose products issue together

enum Regime { kDecode = 0, kWgmma = 1, kTiled = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(f16 x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
// round to nearest even; past 65504 an fp16 output is inf, as JAX's astype
__device__ __forceinline__ void store(f16* p, float x) {
  *p = __float2half_rn(x);
}

// 8 consecutive elements of x as fp32 (16- or 32-byte aligned)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const f16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(h[e]);
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

// Exact int -> fp32 without a conversion instruction: an integer u in
// [0, 256) placed in the mantissa of 2^23 is the float 2^23 + u.
// byte_f(v, j): signed byte j of v (biased: v ^ 0x80808080), q + 128 - 128;
// nib_f(b, hi): the nibble's two's-complement value from ((x & 0xF) ^ 8).
__device__ __forceinline__ float byte_f(uint32_t biased, int j) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + j)) -
         8388736.0f;
}
__device__ __forceinline__ float nib_f(uint32_t b, bool hi) {
  const uint32_t u = (hi ? b >> 4 : b) & 0xFu;
  return __int_as_float(u ^ 0x4B000008u) - 8388616.0f;
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

// ------------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(BYTES) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 2-D tensor map into shared memory, completed on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled K-major operand:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// m64nNk16 products of 16-bit operands (TY: "bf16" or "f16"), fp32
// accumulators, accumulating (acc = 1) or overwriting them (acc = 0): A
// from registers (the four 32-bit fragments of a 16-wide k block), B
// through a descriptor, K-major (transpose bit 0).  One macro a shape,
// defined for both types: wgmma_n<N>_<TY>.

#define WGMMA_N32(TY) \
__device__ __forceinline__ void wgmma_n32_##TY(float (&d)[16], \
                                          const uint32_t (&a)[4], \
                                          uint64_t b, int acc) { \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." #TY "." #TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)); \
}

#define WGMMA_N64(TY) \
__device__ __forceinline__ void wgmma_n64_##TY(float (&d)[32], \
                                          const uint32_t (&a)[4], \
                                          uint64_t b, int acc) { \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)); \
}

#define WGMMA_N128(TY) \
__device__ __forceinline__ void wgmma_n128_##TY(float (&d)[64], \
                                          const uint32_t (&a)[4], \
                                          uint64_t b, int acc) { \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)); \
}

#define WGMMA_N144(TY) \
__device__ __forceinline__ void wgmma_n144_##TY(float (&d)[72], \
                                          const uint32_t (&a)[4], \
                                          uint64_t b, int acc) { \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %77, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n144k16.f32." #TY "." #TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71" \
      "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)); \
}

#define WGMMA_N256(TY) \
__device__ __forceinline__ void wgmma_n256_##TY(float (&d)[128], \
                                          const uint32_t (&a)[4], \
                                          uint64_t b, int acc) { \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." #TY "." #TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)); \
}

WGMMA_N32(bf16)
WGMMA_N32(f16)
WGMMA_N64(bf16)
WGMMA_N64(f16)
WGMMA_N128(bf16)
WGMMA_N128(f16)
WGMMA_N144(bf16)
WGMMA_N144(f16)
WGMMA_N256(bf16)
WGMMA_N256(f16)

#undef WGMMA_N32
#undef WGMMA_N64
#undef WGMMA_N128
#undef WGMMA_N144
#undef WGMMA_N256

template <typename T, int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int acc = 1) {
#define WGMMA_TY(NN)                                                \
  if constexpr (std::is_same_v<T, f16>) NN##_f16(d, a, b, acc);     \
  else NN##_bf16(d, a, b, acc)
  if constexpr (N == 32) { WGMMA_TY(wgmma_n32); }
  else if constexpr (N == 64) { WGMMA_TY(wgmma_n64); }
  else if constexpr (N == 128) { WGMMA_TY(wgmma_n128); }
  else if constexpr (N == 144) { WGMMA_TY(wgmma_n144); }
  else { WGMMA_TY(wgmma_n256); }
#undef WGMMA_TY
}

// ------------------------------------------------------------- the merge

// The threads that run the merge: the whole block, or (NAMED) the two
// consumer warpgroups of the wgmma kernel on barrier 1.
template <bool NAMED>
__device__ __forceinline__ void sync_merge() {
  if constexpr (NAMED) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// After each thread wrote its part of the block's partials: true in every
// thread of the last of the n blocks of an output tile to get here, which
// then sees all n partials (read them with __ldcg); the counter is reset
// for the next launch.  The barrier orders the block's writes before
// thread 0's release fence and ticket.
template <bool NAMED>
__device__ __forceinline__ bool last_of_group(int* counter, int n) {
  __shared__ int s_last;
  sync_merge<NAMED>();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == n - 1;
    if (last) {
      *counter = 0;   // every block of the tile has its ticket
      __threadfence();
    }
    s_last = last;
  }
  sync_merge<NAMED>();
  return s_last;
}

// A block's 2 hw output features: local column lc < hw is column ca + lc,
// lc >= hw column cb + lc - hw (int8: cb = ca + hw; int4: the packed
// columns p0.. in the low half, p0 + n/2.. in the high), each half valid
// below its limit.
struct Cols {
  int ca, cb, lim_a, lim_b, hw;
  __device__ __forceinline__ int col(int lc) const {
    return lc < hw ? ca + lc : cb + lc - hw;
  }
  __device__ __forceinline__ bool live(int lc) const {
    return lc < hw ? ca + lc < lim_a : cb + lc - hw < lim_b;
  }
};

// The 128 features of a prefill block.
template <bool kInt4>
__device__ __forceinline__ Cols tile_cols(int p0, int n) {
  return kInt4 ? Cols{p0, p0 + n / 2, n / 2, n, 64}
               : Cols{p0, p0 + 64, n, n, 64};
}

// The last block of an output tile: rows [r0, r0 + rows) of its columns,
// the splits' partials added in split order and rounded once.  A thread
// takes two outputs at a time and issues up to 16 splits' loads of both
// before it adds them.
template <typename T, bool NAMED, int THREADS>
__device__ void merge_tile(const float* __restrict__ ws, T* __restrict__ out,
                           int m, int n, int splits, int r0, int rows,
                           Cols cols) {
  const long mn = (long)m * n;
  const int width = 2 * cols.hw;
  for (int base = 0; base < rows * width; base += 2 * THREADS) {
    long at[2];
    bool live[2];
    float total[2] = {0.0f, 0.0f};
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int idx = base + o * THREADS + threadIdx.x;
      const int r = r0 + idx / width, lc = idx % width;
      live[o] = idx < rows * width && r < m && cols.live(lc);
      at[o] = live[o] ? (long)r * n + cols.col(lc) : 0;
    }
    for (int z0 = 0; z0 < splits; z0 += 16) {
      float part[2][16];
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int z = 0; z < 16; ++z)
          part[o][z] = live[o] && z0 + z < splits
                           ? __ldcg(ws + (z0 + z) * mn + at[o]) : 0.0f;
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int z = 0; z < 16; ++z)
          if (z0 + z < splits) total[o] += part[o][z];
    }
#pragma unroll
    for (int o = 0; o < 2; ++o)
      if (live[o]) store(out + at[o], total[o]);
  }
}

// ----------------------------------------------------------------- decode
// Grid (feature tiles, k splits), kDecodeThreads threads: warp w takes
// rows w, w + 8, ... of each ring stage, lane l four features of a row:
// int8 bytes [4l, 4l + 4) (local features 4l..4l + 3); int4 packed bytes
// [2l, 2l + 2) (local features 2l, 2l + 1 and 64 + 2l, 64 + 2l + 1).
// Shared memory: the ring (kDecodeStages stages of kDecodeRows weight
// rows, then their scales; after the loop the warps' sums), the x slice as
// fp32 [kc][MT], and the x slice as it lands ([MT][kc] in x's dtype), all
// brought by cp.async.
constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;

template <bool kInt4>
struct DecodeLayout {
  static constexpr int ROW = kInt4 ? 64 : 128;   // weight bytes of a row
  static constexpr int SW = kInt4 ? 18 : 9;      // scale slots of a row
  static constexpr int WBYTES = kDecodeRows * ROW;
  static constexpr int STAGE = WBYTES + kDecodeRows * SW * 4;  // 128 * j
  static constexpr int RING = kDecodeStages * STAGE;
  // the ring, or the warps' sums [warps][mt][128] after it
  __host__ __device__ static constexpr int xs_off(int mt) {
    return RING > kDecodeWarps * mt * 512 ? RING : kDecodeWarps * mt * 512;
  }
  __host__ __device__ static constexpr int xraw_off(int kc, int mt) {
    return xs_off(mt) + kc * mt * 4;
  }
  static int bytes(int kc, int mt, int elem) {
    return xraw_off(kc, mt) + mt * kc * elem;
  }
};

template <typename T, int MT, bool kInt4>
__global__ void __launch_bounds__(kDecodeThreads)
dequant_decode(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scales, T* __restrict__ out,
               float* __restrict__ ws, int* __restrict__ counters, int m,
               int k, int n, int block, int kc) {
  using L = DecodeLayout<kInt4>;
  constexpr int R = kDecodeRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + L::xs_off(MT));
  T* xraw = reinterpret_cast<T*>(smem + L::xraw_off(kc, MT));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = kInt4 ? n / 2 : n;
  const int nb = n / block;
  const int p0 = blockIdx.x * L::ROW;          // the tile's first packed col
  const int k0 = blockIdx.y * kc;
  const int rows = min(kc, k - k0);
  const int splits = gridDim.y;
  // the scale columns of the tile's (first half's) features
  const int sb0 = p0 / block;
  const int sw = (min(p0 + L::ROW, nq) - 1) / block - sb0 + 1;
  const int sws = kInt4 ? 2 * sw : sw;

  // a stage: R weight rows of 16-byte (int8) or 8-byte (int4) pieces, 8
  // a row, and each row's scales, 4 bytes a copy
  auto issue = [&](int s) {
    unsigned char* wdst = smem + (s % kDecodeStages) * L::STAGE;
    float* sdst = reinterpret_cast<float*>(wdst + L::WBYTES);
    const int r0 = s * R;
    constexpr int PIECE = L::ROW / 8;
    for (int idx = tid; idx < R * 8; idx += kDecodeThreads) {
      const int r = idx / 8, col = p0 + (idx % 8) * PIECE;
      if (r0 + r < rows && col < nq)
        cp_async<PIECE>(wdst + r * L::ROW + (idx % 8) * PIECE,
                        q + (long)(k0 + r0 + r) * nq + col);
    }
    for (int idx = tid; idx < R * sws; idx += kDecodeThreads) {
      const int r = idx / sws, j = idx % sws;
      const int sc = j < sw ? sb0 + j : sb0 + nb / 2 + j - sw;
      if (r0 + r < rows)
        cp_async<4>(sdst + r * L::SW + j,
                    scales + (long)(k0 + r0 + r) * nb + sc);
    }
  };

  const int nst = (rows + R - 1) / R;
#pragma unroll
  for (int s = 0; s < kDecodeStages - 1; ++s) {
    if (s < nst) issue(s);
    if (s == 0) {
      // x[:m, k0:k0 + rows] lands with the first stage (16-byte pieces:
      // rows is a multiple of 8, k0 of 16)
      constexpr int PER = 16 / sizeof(T);
      const int pieces = (rows + PER - 1) / PER;
      for (int idx = tid; idx < m * pieces; idx += kDecodeThreads) {
        const int i = idx / pieces, pc = idx % pieces;
        cp_async<16>(xraw + i * kc + pc * PER,
                     x + (long)i * k + k0 + pc * PER);
      }
    }
    cp_async_commit();
  }

  const int c = p0 + lane * (kInt4 ? 2 : 4);   // the lane's packed column
  const bool live = c < nq;
  const int sc_lo = c / block - sb0;
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();
    if (s == 0) {
      // x as fp32 [row][MT], rows of x past m zero
      for (int idx = tid; idx < rows * MT; idx += kDecodeThreads) {
        const int r = idx / MT, i = idx % MT;
        xs[idx] = i < m ? to_float(xraw[i * kc + r]) : 0.0f;
      }
      __syncthreads();
    }
    if (s + kDecodeStages - 1 < nst) issue(s + kDecodeStages - 1);
    cp_async_commit();
    const unsigned char* wsrc = smem + (s % kDecodeStages) * L::STAGE;
    const float* ssrc = reinterpret_cast<const float*>(wsrc + L::WBYTES);
#pragma unroll
    for (int jj = 0; jj < R / kDecodeWarps; ++jj) {
      const int r = warp + kDecodeWarps * jj;
      if (!live || s * R + r >= rows) continue;
      float w[4];
      if constexpr (!kInt4) {
        const uint32_t v =
            *reinterpret_cast<const uint32_t*>(wsrc + r * L::ROW + lane * 4) ^
            0x80808080u;
        const float sv = ssrc[r * L::SW + sc_lo];
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = byte_f(v, e) * sv;
      } else {
        const uint32_t v = *reinterpret_cast<const uint16_t*>(
            wsrc + r * L::ROW + lane * 2);
        const float slo = ssrc[r * L::SW + sc_lo];
        const float shi = ssrc[r * L::SW + sw + sc_lo];
        w[0] = nib_f(v, false) * slo;
        w[1] = nib_f(v >> 8, false) * slo;
        w[2] = nib_f(v, true) * shi;
        w[3] = nib_f(v >> 8, true) * shi;
      }
      const float* xr = xs + (s * R + r) * MT;
#pragma unroll
      for (int i = 0; i < MT; i += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + i);
        const float xi[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i + u][e] = fmaf(xi[u], w[e], acc[i + u][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();      // every thread is past the ring: it holds red now

  // the warps' sums of each (row, feature), added by a fixed pairwise tree
  float* red = reinterpret_cast<float*>(smem);   // [warp][MT][128]
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= m) break;
    float* dst = red + (warp * MT + i) * 128;
    if constexpr (!kInt4) {
      *reinterpret_cast<float4*>(dst + 4 * lane) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      *reinterpret_cast<float2*>(dst + 2 * lane) =
          make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(dst + 64 + 2 * lane) =
          make_float2(acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  const Cols cols = tile_cols<kInt4>(p0, n);
  for (int idx = tid; idx < m * 128; idx += kDecodeThreads) {
    const int i = idx / 128, lc = idx % 128;
    if (!cols.live(lc)) continue;
    float v[kDecodeWarps];
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) v[w] = red[(w * MT + i) * 128 + lc];
#pragma unroll
    for (int h = kDecodeWarps / 2; h >= 1; h /= 2)
#pragma unroll
      for (int j = 0; j < h; ++j) v[j] = v[2 * j] + v[2 * j + 1];
    const long at = (long)i * n + cols.col(lc);
    if (splits == 1)
      store(out + at, v[0]);
    else
      ws[(long)blockIdx.y * m * n + at] = v[0];
  }
  if (splits == 1 || !last_of_group<false>(counters + blockIdx.x, splits))
    return;
  merge_tile<T, false, kDecodeThreads>(ws, out, m, n, splits, 0, m, cols);
}

// ---------------------------------------------------- prefill, fp32 x
// Grid (column tiles, row tiles, k splits).  The block's 128 output
// columns: int8 [n0, n0 + 128); int4 the packed columns [p0, p0 + 64),
// i.e. output columns [p0, p0 + 64) and [p0 + n/2, p0 + n/2 + 64).
// Shared-memory column lc < 64 is the first range, lc >= 64 the second.
template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads)
dequant_tiled(const T* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scales, T* __restrict__ out,
              float* __restrict__ ws, int* __restrict__ counters, int m,
              int k, int n, int block, int kc) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = kInt4 ? n / 2 : n;
  const int nb = n / block;
  const int m0 = blockIdx.y * BM;
  const int p0 = blockIdx.x * (kInt4 ? BN / 2 : BN);
  const int k_begin = blockIdx.z * kc;
  const int k_end = min(k, k_begin + kc);

  // x loads: row tid / 2, 16 consecutive k from (tid % 2) * 16
  const int a_row = tid / 2, a_k = (tid % 2) * 16;
  const bool a_live = m0 + a_row < m;
  // weight loads: k row tid / 8; int8 columns (tid % 8) * 16 (16 bytes),
  // int4 packed columns (tid % 8) * 8 (8 bytes)
  const int b_row = tid / 8, b_j = tid % 8;
  const int b_c = p0 + b_j * (kInt4 ? 8 : 16);
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
  const Cols cols = tile_cols<kInt4>(p0, n);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lc = j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4;
      if (!cols.live(lc)) continue;
      const long at = (long)row * n + cols.col(lc);
      if (split)
        ws[(long)blockIdx.z * m * n + at] = acc[i][j];
      else
        store(out + at, acc[i][j]);
    }
  }
  if (!split || !last_of_group<false>(
                    counters + (long)blockIdx.y * gridDim.x + blockIdx.x,
                    gridDim.z))
    return;
  merge_tile<T, false, kThreads>(ws, out, m, n, gridDim.z, m0, BM, cols);
}

// -------------------------------------------------- prefill, bf16 x
// Grid (feature tiles, token tiles of N, k splits), 384 threads: consumer
// warpgroups 0 and 1 (64 features each), the producer warpgroup 2.  Shared
// memory, from a 1024-byte-aligned base: kWgStages stages of [x tile: N
// rows x 128 bytes (64 bf16 of k), 128-byte swizzle][raw weight tile:
// 64 k rows x 128 bytes int8 (128-byte swizzle) or 64 bytes int4 (64-byte
// swizzle)], then the full and empty mbarriers.
template <int N, bool kInt4>
struct WgLayout {
  static constexpr int XB = N * 128;
  static constexpr int WROW = kInt4 ? 64 : 128;
  static constexpr int WB = kWgK * WROW;
  static constexpr int STAGE = XB + WB;      // a multiple of 1024
  static constexpr int BAR_OFF = kWgStages * STAGE;
  static constexpr int BYTES = BAR_OFF + 16 * kWgStages + 1024;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
};

// Byte offset of (k row r, byte col) in a swizzled raw weight tile.
template <bool kInt4>
__device__ __forceinline__ int wtile_off(int r, int col) {
  return kInt4 ? (r * 64 + col) ^ (((r >> 1) & 3) << 4)
               : (r * 128 + col) ^ ((r & 7) << 4);
}

// Two fp32 values as a packed pair of T (bf16 or fp16), rounded to
// nearest even, and the pair back in fp32.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (std::is_same_v<T, f16>) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (std::is_same_v<T, f16>)
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The A fragments (hi and lo, in T) of one 16-row k step: this thread's
// rows 2c, 2c + 1, 2c + 8, 2c + 9 of the step and its two features (the
// two bytes of one 2-byte load; int4: nibble `hi` of each), scaled by sc.
template <typename T, bool kInt4>
__device__ __forceinline__ void make_frags(const unsigned char* wt, int kr0,
                                           int col, bool hi_nibble,
                                           const float* sc, uint32_t (&fh)[4],
                                           uint32_t (&fl)[4]) {
  float w[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = kr0 + (u & 1) + 8 * (u >> 1);
    const uint32_t b =
        *reinterpret_cast<const uint16_t*>(wt + wtile_off<kInt4>(r, col));
    float q0, q1;
    if constexpr (!kInt4) {
      q0 = byte_f(b ^ 0x8080u, 0);
      q1 = byte_f(b ^ 0x8080u, 1);
    } else {
      q0 = nib_f(b, hi_nibble);
      q1 = nib_f(b >> 8, hi_nibble);
    }
    w[u][0] = q0 * sc[u];
    w[u][1] = q1 * sc[u];
  }
  // fragment j: A row (feature) j & 1, k pair j >> 1: (w[2p], w[2p + 1])
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = j & 1, p = j >> 1;
    fh[j] = pack2<T>(w[2 * p][f], w[2 * p + 1][f]);
    const float2 hf = unpack2<T>(fh[j]);
    fl[j] = pack2<T>(w[2 * p][f] - hf.x, w[2 * p + 1][f] - hf.y);
  }
}

// fp16 only: the largest |scale| of each of the block's scale columns
// over the split's k rows, as fp32 bits (non-negative floats order as
// their bits), for the power of two each feature's weights are scaled by.
// Slot 16 h + j: column (first feature of half h) / block + j; a half
// holds at most 128 / 16 + 1 (int8) or 64 / 8 + 1 (int4) columns.
constexpr int kWmaxSlots = 32;

// The power-of-two exponent e of a feature whose weights' scales reach
// smax: the largest |w| = |q| * s (|q| <= qmax) times 2^e lies in
// [2^14, 2^15), so w * 2^e, its fp16 hi part and the lo part of every
// weight within 2^-24 of the largest stay normal (above 2^-14), and none
// reaches fp16's 65504.  0 for an all-zero (or non-finite) column.
__device__ __forceinline__ int weight_exponent(float smax, float qmax) {
  const float top = smax * qmax;
  if (!(top > 0.0f) || !isfinite(top)) return 0;
  return min(100, max(-100, 14 - ilogbf(top)));
}
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

template <typename T, int N, bool kInt4>
__global__ void __launch_bounds__(kWgThreads, 1)
dequant_wgmma(const __grid_constant__ CUtensorMap tmx,
              const __grid_constant__ CUtensorMap tmw,
              const float* __restrict__ scales, T* __restrict__ out,
              float* __restrict__ ws, int* __restrict__ counters, int m,
              int k, int n, int block, int kc) {
  using L = WgLayout<N, kInt4>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full0 = base + L::BAR_OFF;
  const uint32_t empty0 = full0 + 8 * kWgStages;

  const int wg = threadIdx.x / 128;
  const int nq = kInt4 ? n / 2 : n;
  const int p0 = blockIdx.x * (kInt4 ? 64 : 128);
  const int m0 = blockIdx.y * N;
  const int k0 = blockIdx.z * kc;
  const int slabs = (min(k, k0 + kc) - k0 + kWgK - 1) / kWgK;

  constexpr bool kHalf = std::is_same_v<T, f16>;
  // a half's first feature: the low nibbles' (or int8's) p0, the high
  // nibbles' p0 + n/2
  auto first_feature = [&](int h) { return p0 + h * nq; };
  __shared__ unsigned s_wmax[kWmaxSlots];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);     // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kHalf) {
    if (threadIdx.x < kWmaxSlots) s_wmax[threadIdx.x] = 0u;
  }
  __syncthreads();
  if constexpr (kHalf) {
    // the whole block scans the split's scales of its columns
    const int nb = n / block, k1 = min(k, k0 + kc);
    const int width = kInt4 ? 64 : 128;
    for (int h = 0; h < (kInt4 ? 2 : 1); ++h) {
      const int fa = first_feature(h);
      const int fb = first_feature(h) + min(width, nq - p0) - 1;
      for (int col = fa / block; col <= fb / block; ++col) {
        float mx = 0.0f;
        for (int r = k0 + threadIdx.x; r < k1; r += kWgThreads)
          mx = fmaxf(mx, fabsf(__ldg(scales + (long)r * nb + col)));
        atomicMax(&s_wmax[16 * h + col - fa / block], __float_as_uint(mx));
      }
    }
    __syncthreads();
  }

  if (wg == 2) {
    // ------------------------------------------------------- producer
    regs_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      for (int t = 0; t < slabs; ++t) {
        const int st = t % kWgStages;
        if (t >= kWgStages)
          mbar_wait(empty0 + 8 * st, (t / kWgStages - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t dst = base + st * L::STAGE;
        mbar_expect_tx(full, L::STAGE);
        tma_load(dst, &tmx, full, k0 + t * kWgK, m0);
        tma_load(dst + L::XB, &tmw, full, p0, k0 + t * kWgK);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  regs_inc<L::CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int j = lane / 4, c = lane % 4;
  // A rows 16 warp + j and 16 warp + j + 8 are the features f0, f0 + 1
  const int f0 = 16 * warp + 2 * j;
  const int bcol = kInt4 ? f0 : 64 * wg + f0;           // byte in a row
  const int pcol = p0 + bcol;                           // packed column
  const int fcol = kInt4 ? pcol + wg * nq : pcol;       // output feature
  const bool flive = pcol < nq;
  const int nb = n / block;
  const float* srow = scales + (flive ? fcol / block : 0);
  // fp16: this thread's features' weights are scaled by 2^e before the
  // hi + lo split (folded into the scales: exact, a power of two), and
  // the sums by 2^-e after, in fp32
  int e = 0;
  if constexpr (kHalf) {
    const int h = kInt4 ? wg : 0;
    if (flive)
      e = weight_exponent(
          __uint_as_float(s_wmax[16 * h + fcol / block -
                                 first_feature(h) / block]),
          kInt4 ? 8.0f : 127.0f);
  }
  const float up = pow2(e);

  // the scales of this thread's 16 rows of slab t: k step s, row u
  auto load_scales = [&](int t, float (&sc)[16]) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = k0 + t * kWgK + 16 * s + 2 * c + (u & 1) + 8 * (u >> 1);
        float v = flive && r < k ? __ldg(srow + (long)r * nb) : 0.0f;
        if constexpr (kHalf) v *= up;
        sc[4 * s + u] = v;
      }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  // fp16: the sum of the groups before the one in flight, added in fp32
  // on the CUDA cores (below)
  float total[kHalf ? N / 2 : 1];
#pragma unroll
  for (int i = 0; i < (kHalf ? N / 2 : 1); ++i) total[i] = 0.0f;
  // the k steps go in groups of G: a group's fragments are built while the
  // previous group's 2G products run, then its products issue back to back
  // (two buffers of G steps' fragments)
  constexpr int G = kWgGroup;   // 4: a slab; 2G must divide 4 or 4 divide G
  uint32_t fh[2][G][4], fl[2][G][4];
  float sc[16], sn[16];
  load_scales(0, sc);
  if (slabs > 1) load_scales(1, sn);
  mbar_wait(full0, 0);
#pragma unroll
  for (int j = 0; j < G; ++j)
    make_frags<T, kInt4>(gbase + L::XB, 16 * j + 2 * c, bcol, wg == 1,
                         sc + 4 * j, fh[0][j], fl[0][j]);

  const int steps = 4 * slabs;
  for (int g0 = 0; g0 < steps; g0 += 2 * G) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {             // the group's buffer
      const int g = g0 + h * G;               // its first k step
      if (g >= steps) break;
      const int t = g / 4, s0 = (h * G) % 4;  // slab, first step in it
      const uint64_t dx = gmma_desc(base + (t % kWgStages) * L::STAGE);
      if constexpr (kHalf) {
        // the tensor cores add into the accumulator with truncation, a
        // bias that grows with the products a sum takes (3% of fp16
        // outputs a ulp off at k = 4096, 1% at 1024): each group's
        // products start a fresh sum, added to the total here in fp32
        wgmma_wait<0>();
        fence_regs(acc);
        if (g > 0) {
#pragma unroll
          for (int i = 0; i < N / 2; ++i) total[i] += acc[i];
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < G; ++j) {
        // 32 bytes a k step; fp16: the group's first product overwrites
        wgmma<T, N>(acc, fh[h][j], dx + 2 * (s0 + j),
                    kHalf && j == 0 ? 0 : 1);
        wgmma<T, N>(acc, fl[h][j], dx + 2 * (s0 + j));
      }
      wgmma_commit();
      wgmma_wait<1>();                 // the previous group's products done
      // the previous group ended slab t - 1: release it
      if (s0 == 0 && t > 0 && lane == 0)
        mbar_arrive(empty0 + 8 * ((t - 1) % kWgStages));
      const int gn = g + G;            // the next group
      if (gn < steps) {
        const int nt = gn / 4, ns = ((h + 1) * G) % 4;
        if (ns == 0) {
#pragma unroll
          for (int i = 0; i < 16; ++i) sc[i] = sn[i];
          if (nt + 1 < slabs) load_scales(nt + 1, sn);
          mbar_wait(full0 + 8 * (nt % kWgStages), (nt / kWgStages) & 1);
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
          make_frags<T, kInt4>(gbase + (nt % kWgStages) * L::STAGE + L::XB,
                               16 * (ns + j) + 2 * c, bcol, wg == 1,
                               sc + 4 * (ns + j), fh[1 - h][j], fl[1 - h][j]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (kHalf) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += total[i];
  }

  // acc[i]: token 8 (i >> 2) + 2c + (i & 1), feature f0 + ((i >> 1) & 1)
  const int splits = gridDim.z;
  const float down = pow2(-e);
  if (flive) {
#pragma unroll
    for (int g = 0; g < N / 8; ++g)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int tok = m0 + 8 * g + 2 * c + e2;
        if (tok >= m) continue;
        float v0 = acc[4 * g + e2], v1 = acc[4 * g + 2 + e2];
        if constexpr (kHalf) {
          v0 *= down;
          v1 *= down;
        }
        const long at = (long)tok * n + fcol;
        if (splits == 1)
          *reinterpret_cast<uint32_t*>(out + at) = pack2<T>(v0, v1);
        else
          *reinterpret_cast<float2*>(ws + (long)blockIdx.z * m * n + at) =
              make_float2(v0, v1);
      }
  }
  if (splits == 1 ||
      !last_of_group<true>(counters + (long)blockIdx.y * gridDim.x +
                                    blockIdx.x, splits))
    return;
  merge_tile<T, true, 256>(ws, out, m, n, splits, m0, N,
                           tile_cols<kInt4>(p0, n));
}

// ------------------------------------------------------------------ launch

template <typename K>
cudaError_t opt_in(K kernel, int bytes, int* done) {
  if (*done >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = bytes;
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (null if libcuda has none), so the library links nothing beyond
// the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A 2-D map over a row-major (rows, cols) tensor of `elem` bytes: boxes of
// box_cols x box_rows, zero fill past every edge.
bool encode_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                int elem, long rows, long cols, int box_cols, int box_rows,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 ||
      (cols * elem) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int MT, bool kInt4>
cudaError_t launch_decode_mt(const T* x, const int8_t* q, const float* scales,
                             T* out, float* ws, int* counters, int m, int k,
                             int n, int block, int kc, int splits,
                             cudaStream_t stream) {
  using L = DecodeLayout<kInt4>;
  const int nq = kInt4 ? n / 2 : n;
  auto kernel = dequant_decode<T, MT, kInt4>;
  static int opted = 0;
  const cudaError_t err =
      opt_in(kernel, L::bytes(kDecodeMaxKc, MT, sizeof(T)), &opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + L::ROW - 1) / L::ROW, splits);
  kernel<<<grid, kDecodeThreads, L::bytes(kc, MT, sizeof(T)), stream>>>(
      x, q, scales, out, ws, counters, m, k, n, block, kc);
  return cudaGetLastError();
}

template <typename T, bool kInt4>
cudaError_t launch_decode(const T* x, const int8_t* q, const float* scales,
                          T* out, float* ws, int* counters, int m, int k,
                          int n, int block, int kc, int splits,
                          cudaStream_t stream) {
  if (m <= 4)
    return launch_decode_mt<T, 4, kInt4>(x, q, scales, out, ws, counters, m,
                                         k, n, block, kc, splits, stream);
  return launch_decode_mt<T, 8, kInt4>(x, q, scales, out, ws, counters, m, k,
                                       n, block, kc, splits, stream);
}

template <typename T, bool kInt4>
cudaError_t launch_tiled(const T* x, const int8_t* q, const float* scales,
                         T* out, float* ws, int* counters, int m, int k,
                         int n, int block, int kc, int splits,
                         cudaStream_t stream) {
  const int nq = kInt4 ? n / 2 : n;
  const int cols = kInt4 ? BN / 2 : BN;
  const dim3 grid((nq + cols - 1) / cols, (m + BM - 1) / BM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  dequant_tiled<T, kInt4><<<grid, kThreads, 0, stream>>>(
      x, q, scales, out, ws, counters, m, k, n, block, kc);
  return cudaGetLastError();
}

template <typename T, int N, bool kInt4>
cudaError_t launch_wgmma(const T* x, const int8_t* q, const float* scales,
                         T* out, float* ws, int* counters, int m, int k,
                         int n, int block, int kc, int splits,
                         cudaStream_t stream) {
  using L = WgLayout<N, kInt4>;
  const int nq = kInt4 ? n / 2 : n;
  const dim3 grid((nq + L::WROW - 1) / L::WROW, (m + N - 1) / N, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  CUtensorMap tmx, tmw;
  if (!encode_map(&tmx, x,
                  std::is_same_v<T, f16> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, m, k, kWgK, N, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tmw, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, nq, L::WROW,
                  kWgK, kInt4 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static int opted = 0;
  const cudaError_t err =
      opt_in(dequant_wgmma<T, N, kInt4>, L::BYTES, &opted);
  if (err != cudaSuccess) return err;
  dequant_wgmma<T, N, kInt4><<<grid, kWgThreads, L::BYTES, stream>>>(
      tmx, tmw, scales, out, ws, counters, m, k, n, block, kc);
  return cudaGetLastError();
}

template <typename T, bool kInt4>
cudaError_t wgmma_tile(int tile, const T* x, const int8_t* q,
                       const float* scales, T* out, float* ws,
                       int* counters, int m, int k, int n, int block, int kc,
                       int splits, cudaStream_t s) {
#define WGMMA(N)                                                           \
  case N:                                                                  \
    return launch_wgmma<T, N, kInt4>(x, q, scales, out, ws, counters, m, k, \
                                     n, block, kc, splits, s)
  switch (tile) {
    WGMMA(32);
    WGMMA(64);
  }
  // fp16 keeps a second set of sums (the total) beside the accumulators:
  // its tiles stop at 64 tokens
  if constexpr (!std::is_same_v<T, f16>) {
    switch (tile) {
      WGMMA(128);
      WGMMA(144);
      WGMMA(256);
    }
  }
#undef WGMMA
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (m, k) fp32 (dtype 0), bf16 (1) or fp16 (2: only the build with
// DEQUANT_F16 defined, dequant_matmul_f16.cu, takes it, and only it);
// q int8 (k, n) or packed int4
// (k, n/2) (int4 = 1); scales (k, n/block) fp32; out (m, n) in x's dtype.
// regime 0: the decode kernel (m <= 8, kc <= 1024 a multiple of 8);
// 1: the wgmma kernel (bf16 or fp16 x, tile tokens a block: 32, 64, 128, 144 or
// 256; kc a multiple of 64; int4 needs n/2 % 16 == 0); 2: the tiled kernel
// (kc a multiple of 32; fp32 x, or 16-bit x over int4 weights).  k is cut into splits of kc rows; with more than
// one, work holds (splits, m, n) fp32 and counters one zeroed int32 per
// output tile, which the kernel leaves at 0.  Needs k % 8 == 0 and, for
// int8, n % 16 == 0 and block % 16 == 0; for int4, (n/2) % 8 == 0, block %
// 8 == 0 and (n/2) % block == 0.  Returns a cudaError_t code (0 =
// success).
int dequant_matmul(const void* x, const void* q, const float* scales,
                   void* out, float* work, int* counters, int m, int k, int n,
                   int block, int int4, int dtype, int regime, int tile,
                   int kc, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // this build's element types: fp32 and bf16, or (DEQUANT_F16) fp16 only
#if defined(DEQUANT_F16)
  using H = f16;
  const bool fp32 = false, ok = dtype == 2;
#else
  using H = bf16;
  const bool fp32 = dtype == 0, ok = dtype == 0 || dtype == 1;
#endif
  if (m < 1 || k < 8 || k % 8 || n < 1 || block < 1 || n % block ||
      kc < 1 || splits < 1 || (long)(splits - 1) * kc >= k ||
      (long)splits * kc < k || !ok ||
      (splits > 1 && (work == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (int4 ? (n % 2 || (n / 2) % 8 || block % 8 || (n / 2) % block)
           : (n % 16 || block % 16))
    return cudaErrorInvalidValue;
  const int8_t* qb = static_cast<const int8_t*>(q);
  if (regime == kDecode) {
    if (m > kDecodeMaxM || kc > kDecodeMaxKc || kc % 16)
      return cudaErrorInvalidValue;
#define DECODE(T, I4)                                                       \
  return launch_decode<T, I4>(static_cast<const T*>(x), qb, scales,        \
                              static_cast<T*>(out), work, counters, m, k,  \
                              n, block, kc, splits, s)
#if !defined(DEQUANT_F16)
    if (fp32) {
      if (int4) DECODE(float, true);
      DECODE(float, false);
    }
#endif
    if (int4) DECODE(H, true);
    DECODE(H, false);
#undef DECODE
  }
  if (regime == kWgmma) {
    if (fp32 || kc % kWgK || (int4 && (n / 2) % 16))
      return cudaErrorInvalidValue;
    const H* xh = static_cast<const H*>(x);
    H* oh = static_cast<H*>(out);
    if (int4)
      return wgmma_tile<H, true>(tile, xh, qb, scales, oh, work, counters, m,
                                 k, n, block, kc, splits, s);
    return wgmma_tile<H, false>(tile, xh, qb, scales, oh, work, counters, m,
                                k, n, block, kc, splits, s);
  }
  if (regime == kTiled) {
    if (kc % BK) return cudaErrorInvalidValue;
#define TILED(T, I4)                                                        \
  return launch_tiled<T, I4>(static_cast<const T*>(x), qb, scales,         \
                             static_cast<T*>(out), work, counters, m, k, n, \
                             block, kc, splits, s)
#if !defined(DEQUANT_F16)
    if (fp32) {
      if (int4) TILED(float, true);
      TILED(float, false);
    }
#endif
    // 16-bit x reaches this kernel only over int4 weights whose n/2 is not
    // a multiple of 16 (no TMA map); over int8 it always takes wgmma
    if (int4) TILED(H, true);
#undef TILED
  }
  return cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
