// The bf16 and fp16 attention forward for Hopper (sm_90a): TMA loads, a
// producer warpgroup and consumer warpgroups, wgmma products with the
// scores and the output in registers.  The short, mid (attention_common.cuh's
// attn::fwd) and flash (attention_flash.cu) entries launch it for bf16 and
// fp16 inputs; their fp32 instances keep the SIMT FMA kernels of those
// files (wgmma has no fp32 form, and TF32 would break the fp32 parity that
// Precision.HIGHEST asks for).  The element type T is a template parameter
// (Elem<T>): the products' type string (.bf16 or .f16), the tensor maps'
// data type and the round-to-nearest conversions of P, the scaled Q and
// the output.  No conversion saturates: an fp16 value past 65504 becomes
// inf, as a plain cast gives.  The fp16 instances are built in their own
// sources (attention_*_f16.cu), so the bf16 ones are the same code as
// before.
//
// Replaces, for bf16 and fp16 inputs:
//   apex_tpu/ops/attention_short.py::_short_fwd_kernel (:149, call :359)
//   apex_tpu/ops/attention_mid.py::_mid_fwd_kernel     (:213, call :540)
//   apex_tpu/ops/attention.py::_fa_fwd_kernel          (:213, call :396)
//
// Function: exactly what each entry's plain version computes.  Scores in
// fp32, the online softmax over key tiles (running max m, running sum l,
// the output rescaled in registers), masked scores the finite -1e30 and
// masked probabilities exactly 0, l clamped at 1e-30, out = acc / l in
// T, lse = m + log(l) (fp32, natural log) for the unchanged backward
// kernels.  Two rounding orders, a template flag (QSCALE):
//   - short/mid (QSCALE false, _short_fwd_plain): s = (q . k) * scale in
//     fp32, then + bias;
//   - flash (QSCALE true, _flash_fwd_plain): q * scale in fp32 rounded to
//     T before the product (each warpgroup scales its own rows of the Q
//     tile in shared memory once it lands), s = (q * scale) . k + bias.
// The variants are template flags with the predicates of
// attention_tiles.cuh: SEGS (q_ids[i] == kv_ids[j]; a row that sees no key
// ends with l = 0, so out 0 and lse about -1e30), DROP (l summed before
// dropout; only the p that enters P . V is dropped and scaled; the hash
// over the global bh and the absolute positions, so the masks are the
// plain versions' and JAX's), BIAS (added after the scale, before the
// predicate; a row the bias alone hides stays visible and is the uniform
// mean of V).  Causal is top-left aligned (key <= query by index), and sq,
// sk need not be multiples of a tile.
//
// Design (one block per (bh, query tile of 64 * NC rows)):
//  - TMA with 128-byte swizzle.  Each operand has a 3-D tensor map over
//    (d, s, bh), encoded on the host for each call and passed as a
//    __grid_constant__ parameter; rows past a sequence's end are outside
//    the map and land as zeros (a 2-D map over (bh * s, d) would read the
//    next head's rows there).  A 128-byte swizzle row holds 64 bf16, so a
//    d = 128 tile is two 64-column slabs.  The Q tile lands once; K and V
//    tiles of kKT = 128 keys stream through a ring of kStages = 2 stages,
//    each completed on a "full" mbarrier (transaction bytes) and released
//    on an "empty" one (one arrival per consumer warp).
//  - Warp specialisation: NC consumer warpgroups of 64 query rows each, and
//    one producer warpgroup whose first thread issues every load.
//    setmaxnreg moves registers to the consumers (24 for the producer, 240
//    or 232 for the consumers: the block's whole register file).  A lone
//    producer warp without it is no cheaper: a block of 9 warps puts 3 on
//    one of the SM's four 16K-register quarters, so ptxas held every thread
//    to 168 registers, and the bias instances spilled up to 2.4 KB.  With
//    setmaxnreg only the bias instances spill, 88-316 bytes (the tile's
//    bias, S and O are 192 live registers a thread).
//  - wgmma.mma_async, m64 x kKT x 16 for S = Q . K^T (both operands K-major
//    in shared memory), m64 x D x 16 for O += P . V (P from registers, V
//    read MN-major through the descriptor's transpose bit).  S, P and O
//    stay in registers: scale, bias, mask and online softmax run on the
//    accumulator layout's (row, column) coordinates (each thread holds two
//    rows, each reduced over the four threads that share it); P is
//    converted to bf16 in registers, the accumulator's layout being the A
//    operand's; O is rescaled in registers and normalised in the epilogue,
//    which stores straight from registers.
//  - The predicate runs only where a tile needs it: the causal diagonal,
//    the ragged last key tile, and every tile with SEGS; interior tiles
//    take a path without it.  A masked score is -2e30, below the running
//    max's floor of -1e30, so its probability is exactly 0 without a
//    select, while a score the bias alone sets to -1e30 stays visible.
//    Each thread reads a key tile's ids once a column; the bias of a whole
//    key tile is read while the first product runs, without predicates
//    (rows past sq read row sq - 1), a pair of columns in one 8-byte load
//    where the rows allow it; the ragged last key tile reads its bias
//    under the predicate in the softmax.  Key tiles wholly above the causal
//    diagonal are skipped, and the causal query tiles launch heaviest first
//    (the grid is (bh, query tile) with the tile order reversed, so every
//    block reads its own bh, which the dropout hash, the id row bh / heads
//    and the bias slab take).
//  - The tensor-map encoder is libcuda's cuTensorMapEncodeTiled, its
//    address fetched through the CUDA runtime's entry-point query, so the
//    libraries link nothing beyond the runtime.
//
// What bounds it on the card: at the flagship's training shape (b*h = 64,
// s = 1024, d = 128, causal) the forward does 4 * d flops a causal pair,
// 1.1e10 flops over 67 MB, 0.011 ms of tensor-core time and 0.020 ms of
// memory time; at the Llama mode's (b*h = 16, s = 4096) it is bound by
// operations (0.070 ms).  On an H100 (700 W, chip_smoke.py phase 2) the
// two run 0.060 and 0.141 ms, about SDPA's times.  What the design leaves
// undone (PERF.md): the two products and the softmax of one warpgroup run
// one after the other (no ping-pong of two warpgroups, no overlap inside
// one, as FA3 does), so the variants' work on the CUDA cores (the dropout
// hash, the id compare, the bias read) adds 1.3-1.9x; the epilogue stores
// from registers rather than through TMA.

#pragma once

#include <cuda.h>

#include "attention_tiles.cuh"

#include <type_traits>

namespace attn {
namespace sm90 {
namespace {

constexpr int kKT = 128;       // keys per streamed K/V tile
constexpr int kStages = 2;     // K/V stages in the ring
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
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
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory, completed on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// The warpgroup's own barrier (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// m64nNk16 products of T (bf16 or fp16) with fp32 accumulators: SS reads A and B through
// descriptors (both K-major; accumulate = 0 overwrites d), RS takes A from
// registers (the four 32-bit A fragments of a 16-wide k block) and B
// through a descriptor with the transpose bit (MN-major), accumulating.
// The products' inline PTX, one per shape, with the operand type TY
// ("bf16" or "f16") spliced into the instruction.
#define ATTN_WGMMA_SS_N64(TY)                                      \
  asm volatile(                                                    \
      "{\n.reg .pred p;\n"                                         \
      "setp.ne.b32 p, %34, 0;\n"                                   \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
      "{"                                                          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                   \
      "%24, %25, %26, %27, %28, %29, %30, %31"                     \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])         \
      : "l"(da), "l"(db), "r"(accumulate));

#define ATTN_WGMMA_SS_N128(TY)                                      \
  asm volatile(                                                     \
      "{\n.reg .pred p;\n"                                          \
      "setp.ne.b32 p, %66, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{"                                                           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                            \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
      "%56, %57, %58, %59, %60, %61, %62, %63"                      \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])          \
      : "l"(da), "l"(db), "r"(accumulate));

#define ATTN_WGMMA_RS_N64(TY)                                          \
  asm volatile(                                                        \
      "{\n.reg .pred p;\n"                                             \
      "setp.ne.b32 p, %37, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "      \
      "{"                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                       \
      "%24, %25, %26, %27, %28, %29, %30, %31"                         \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),              \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),            \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),            \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));

#define ATTN_WGMMA_RS_N128(TY)                                         \
  asm volatile(                                                        \
      "{\n.reg .pred p;\n"                                             \
      "setp.ne.b32 p, %69, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "     \
      "{"                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                               \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                       \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                       \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                       \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                       \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                       \
      "%56, %57, %58, %59, %60, %61, %62, %63"                         \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),              \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),            \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),            \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),            \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),            \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),            \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),            \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),            \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),            \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, f16>) {
    ATTN_WGMMA_SS_N64("f16");
  } else {
    ATTN_WGMMA_SS_N64("bf16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, f16>) {
    ATTN_WGMMA_SS_N128("f16");
  } else {
    ATTN_WGMMA_SS_N128("bf16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (std::is_same_v<T, f16>) {
    ATTN_WGMMA_RS_N64("f16");
  } else {
    ATTN_WGMMA_RS_N64("bf16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (std::is_same_v<T, f16>) {
    ATTN_WGMMA_RS_N128("f16");
  } else {
    ATTN_WGMMA_RS_N128("bf16");
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64<T>(d, da, db, accumulate);
  } else {
    wgmma_ss_n128<T>(d, da, db, accumulate);
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64<T>(d, a, db);
  } else {
    wgmma_rs_n128<T>(d, a, db);
  }
}

// The element types of the wgmma kernels: the tensor maps' data type, the
// pair type, and the round-to-nearest conversions (cvt.rn, no
// .satfinite: an fp16 value past 65504 becomes inf).
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  using T2 = __nv_bfloat162;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __forceinline__ T2 pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  __device__ static __forceinline__ float2 unpair(T2 v) {
    return __bfloat1622float2(v);
  }
};

template <>
struct Elem<f16> {
  using T2 = __half2;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static __forceinline__ T2 pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  __device__ static __forceinline__ float2 unpair(T2 v) {
    return __half22float2(v);
  }
};

// Two values rounded to T, as one 32-bit register (an A fragment half).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const typename Elem<T>::T2 v = Elem<T>::pair(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------- layout

// Shared memory of a block, in bytes from a 1024-byte-aligned base: the Q
// tile (D / 64 slabs of QT rows x 128 bytes), then kStages stages of K and
// V (D / 64 slabs of kKT rows each), then the mbarriers.
template <int D, int NC>
struct Smem {
  static constexpr int QT = 64 * NC;
  static constexpr int SLABS = D / 64;
  static constexpr int Q_SLAB = QT * 128;
  static constexpr int KV_SLAB = kKT * 128;
  static constexpr int K_OFF = SLABS * Q_SLAB;
  static constexpr int STAGE = 2 * SLABS * KV_SLAB;
  static constexpr int BAR_OFF = K_OFF + kStages * STAGE;
  // the barriers (Q, kStages full, kStages empty) and the alignment slack
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;
  // the consumer warpgroups, then the producer warpgroup
  static constexpr int THREADS = (NC + 1) * 128;
  // setmaxnreg: the producer's and the consumers' registers, which fill
  // the register file the launch bounds give the block
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NC == 2 ? 240 : 232;
};

struct Params {
  const int* q_ids;    // (bh / heads, sq) int32, with SEGS
  const int* kv_ids;   // (bh / heads, sk) int32, with SEGS
  void* out;           // (bh, sq, D) of the inputs' type
  float* lse;          // (bh, sq)
  int heads, sq, sk, causal;
  float scale;
  Dropout dr;
  Bias bias;
};

// ------------------------------------------------------------------ kernel

// A masked score: below the running max's floor (kNegInf, where m starts),
// so exp2((s - m) * log2 e) is exactly 0 for it whatever the row's max,
// while a score the bias alone pushes to -1e30 stays visible (exp(0) = 1
// when the whole row is there).
constexpr float kMasked = -2e30f;

// One consumer warpgroup's softmax over a key tile held in S (the
// accumulator of S = Q . K^T): scale, bias, the predicate where MASK asks
// for it, the running max and sum of the thread's two rows qi[0], qi[1],
// the rescale of O, and P (T, dropped) as the A fragments of P . V.
// Element i of S is row (i >> 1) & 1 and column 8 (i >> 2) + c0 + (i & 1).
// With a bias, bv holds the tile's values, but on the ragged last key
// tile (ragged), whose in-range values are read here from bias_rows.
template <typename T, int D, bool MASK, bool SEGS, bool DROP, bool BIAS,
          bool QSCALE>
__device__ __forceinline__ void softmax_tile(
    float (&S)[kKT / 2], const float (&bv)[kKT / 2], float (&O)[D / 2],
    uint32_t (&P)[kKT / 4], float (&m)[2], float (&l)[2], const int (&qi)[2],
    const int (&qid)[2], const int* kidb,
    const float* const (&bias_rows)[2],
    bool ragged, int k0, int c0, unsigned hrow, const Params& p) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kj = k0 + 8 * j + c0 + e;
      [[maybe_unused]] int kid = 0;
      if constexpr (MASK && SEGS) kid = kj < p.sk ? __ldg(kidb + kj) : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float x = QSCALE ? S[i] : S[i] * p.scale;
        if constexpr (BIAS) {
          float b = bv[i];
          if (MASK && ragged) b = kj < p.sk ? __ldg(bias_rows[r] + kj) : 0.0f;
          x = __fadd_rn(x, b);
        }
        if constexpr (MASK) {
          const bool vis = kj < p.sk && (!p.causal || kj <= qi[r]) &&
                           (!SEGS || qid[r] == kid);
          x = vis ? x : kMasked;
        }
        S[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }
  float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < kKT / 2; ++i) {
    const int r = (i >> 1) & 1;
    // (s - m) * log2(e): s - m is exact where both are -1e30, and a
    // masked score's is at most -1e30
    float e = exp2f((S[i] - mx[r]) * kLog2e);
    rs[r] += e;
    if constexpr (DROP) {
      const int kj = k0 + 8 * (i >> 2) + c0 + (i & 1);
      e = drop_keep(p.dr, hrow, qi[r], kj) ? e * p.dr.inv_keep : 0.0f;
    }
    S[i] = e;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) O[i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int j = 0; j < kKT / 4; ++j) P[j] = pack2<T>(S[2 * j], S[2 * j + 1]);
}

// The bias of the thread's pairs of a whole key tile (k0 + kKT <= sk),
// read while the tile's first product runs, without a predicate: rows
// past sq read row sq - 1 (bias_rows), which no output takes; as float2
// where a row's pairs are 8-byte aligned (pairs: sk even), one float at a
// time otherwise.
__device__ __forceinline__ void load_bias_tile(
    float (&bv)[kKT / 2], const float* const (&bias_rows)[2], int k0, int c0,
    bool pairs) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = bias_rows[r] + k0 + c0;
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
      float2 v;
      if (pairs) {
        v = __ldg(reinterpret_cast<const float2*>(row + 8 * j));
      } else {
        v.x = __ldg(row + 8 * j);
        v.y = __ldg(row + 8 * j + 1);
      }
      bv[4 * j + 2 * r] = v.x;
      bv[4 * j + 2 * r + 1] = v.y;
    }
  }
}

// q, k, v: the tensor maps of (bh, sq|sk, D) T; grid (bh, query tiles).
template <typename T, int D, int NC, bool SEGS, bool DROP, bool BIAS,
          bool QSCALE>
__global__ void __launch_bounds__(Smem<D, NC>::THREADS, NC == 1 ? 2 : 1)
fwd_kernel(__grid_constant__ const CUtensorMap tq,
           __grid_constant__ const CUtensorMap tk,
           __grid_constant__ const CUtensorMap tv, const Params p) {
  using L = Smem<D, NC>;
  constexpr int QT = L::QT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qbar = base + L::BAR_OFF;
  const uint32_t full0 = qbar + 8;
  const uint32_t empty0 = qbar + 8 + 8 * kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const long bh = blockIdx.x;
  const int tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * QT;
  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = p.causal ? min(p.sk, q0 + QT) : p.sk;
  const int n_tiles = (kv_end + kKT - 1) / kKT;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
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
      mbar_expect_tx(qbar, QT * D * 2);
      for (int s = 0; s < L::SLABS; ++s) {
        tma_load(base + s * L::Q_SLAB, &tq, qbar, 64 * s, q0, (int)bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const int use = t / kStages;
        const uint32_t full = full0 + 8 * st;
        if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
        mbar_expect_tx(full, 2 * kKT * D * 2);
        const uint32_t kdst = base + L::K_OFF + st * L::STAGE;
        const uint32_t vdst = kdst + L::SLABS * L::KV_SLAB;
        for (int s = 0; s < L::SLABS; ++s) {
          tma_load(kdst + s * L::KV_SLAB, &tk, full, 64 * s, t * kKT, (int)bh);
          tma_load(vdst + s * L::KV_SLAB, &tv, full, 64 * s, t * kKT, (int)bh);
        }
      }
      // stay until the consumers have released every stage in flight
      for (int t = max(0, n_tiles - kStages); t < n_tiles; ++t) {
        mbar_wait(empty0 + 8 * (t % kStages), (t / kStages) & 1);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    regs_inc<L::CONSUMER_REGS>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c0 = 2 * (lane % 4);   // first column of each 8-wide block
    const int qi[2] = {q0 + wg * 64 + warp * 16 + lane / 4,
                       q0 + wg * 64 + warp * 16 + lane / 4 + 8};
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
    const float* bslab = BIAS ? bias_slab(p.bias, bh, p.heads) : nullptr;
    const float* bias_rows[2] = {nullptr, nullptr};
    if constexpr (BIAS) {
      for (int r = 0; r < 2; ++r) {
        bias_rows[r] = bslab + (long)min(qi[r], p.sq - 1) * p.sk;
      }
    }
    // a thread's two columns of an 8-wide block are one 8-byte load where
    // every row starts 8-byte aligned
    const bool pairs = BIAS && p.sk % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(bslab) % 8 == 0;

    float O[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) O[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};

    // this warpgroup's 64 rows of each Q slab
    const uint32_t qa = base + wg * 64 * 128;
    mbar_wait(qbar, 0);
    if constexpr (QSCALE) {
      // q * scale in fp32, rounded to T as the product's operand
      using T2 = typename Elem<T>::T2;
      unsigned char* gq = smem_raw + (base - raw) + wg * 64 * 128;
      for (int s = 0; s < L::SLABS; ++s) {
        T2* x = reinterpret_cast<T2*>(gq + s * L::Q_SLAB);
        for (int i = tid; i < 64 * 32; i += 128) {
          const float2 f = Elem<T>::unpair(x[i]);
          x[i] = Elem<T>::pair(f.x * p.scale, f.y * p.scale);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(wg);
    }
    const uint64_t dq = gmma_desc(qa, 16, 1024);

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int k0 = t * kKT;
      const uint32_t ka = base + L::K_OFF + st * L::STAGE;
      const uint32_t va = ka + L::SLABS * L::KV_SLAB;
      mbar_wait(full0 + 8 * st, (t / kStages) & 1);

      // S = Q . K^T: D / 16 k-steps, 32 bytes apart in a slab
      float S[kKT / 2];
      const uint64_t dk = gmma_desc(ka, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t step =
            ((kk / 4) * (uint64_t)L::Q_SLAB + (kk % 4) * 32) >> 4;
        const uint64_t kstep =
            ((kk / 4) * (uint64_t)L::KV_SLAB + (kk % 4) * 32) >> 4;
        wgmma_ss<T, kKT>(S, dq + step, dk + kstep, kk > 0);
      }
      wgmma_commit();
      // the bias of the thread's pairs, read while the product runs
      const bool ragged = k0 + kKT > p.sk;
      [[maybe_unused]] float bv[kKT / 2];
      if constexpr (BIAS) {
        if (!ragged) load_bias_tile(bv, bias_rows, k0, c0, pairs);
      }
      wgmma_wait_all();
      fence_regs(S);

      uint32_t P[kKT / 4];
      const bool masked = SEGS || ragged ||
                          (p.causal && k0 + kKT - 1 > q0 + wg * 64);
      if (masked) {
        softmax_tile<T, D, true, SEGS, DROP, BIAS, QSCALE>(
            S, bv, O, P, m, l, qi, qid, kidb, bias_rows, ragged, k0, c0, hrow,
            p);
      } else {
        softmax_tile<T, D, false, SEGS, DROP, BIAS, QSCALE>(
            S, bv, O, P, m, l, qi, qid, kidb, bias_rows, ragged, k0, c0, hrow,
            p);
      }

      // O += P . V: kKT / 16 k-steps of 16 keys (2048 bytes) each; the two
      // 64-column slabs of V are LBO apart
      const uint64_t dv = gmma_desc(va, L::KV_SLAB, 1024);
      fence_regs(O);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        const uint32_t a[4] = {P[4 * kk], P[4 * kk + 1], P[4 * kk + 2],
                               P[4 * kk + 3]};
        wgmma_rs<T, D>(O, a, dv + ((kk * 2048) >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(O);
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // normalise and store the thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ll = fmaxf(quad_sum(l[r]), 1e-30f);
      const float inv = 1.0f / ll;
      if (qi[r] >= p.sq) continue;
      T* o = static_cast<T*>(p.out) + (bh * p.sq + qi[r]) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<typename Elem<T>::T2*>(o + 8 * j) =
            Elem<T>::pair(O[4 * j + 2 * r] * inv, O[4 * j + 2 * r + 1] * inv);
      }
      if (lane % 4 == 0) p.lse[bh * p.sq + qi[r]] = m[r] + logf(ll);
    }
  }
}

// ------------------------------------------------------------------ launch

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (null if libcuda has none).
inline EncodeTiled encode_tiled() {
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

// A 3-D map over a contiguous (bh, s, d) tensor of T (2 bytes), boxes of
// 64 columns x rows x 1, 128-byte swizzle, zero fill past every edge.
template <typename T>
inline bool encode_map(CUtensorMap* map, const void* ptr, int d, int s,
                       int bh, int rows) {
  static_assert(sizeof(T) == 2, "16-bit elements");
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, Elem<T>::kMap, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The forward of (bh, sq, D) q against (bh, sk, D) k and v of T (bf16, the
// default, or fp16): NC consumer warpgroups (64 * NC query rows a block),
// QSCALE the flash rung's rounding order.
template <int D, int NC, bool SEGS, bool DROP, bool BIAS, bool QSCALE,
          typename T = bf16>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_ids, const int* kv_ids, void* out, float* lse,
                   int bh, int heads, int sq, int sk, int causal, float scale,
                   Dropout dr, Bias bias, cudaStream_t stream) {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  using L = Smem<D, NC>;
  const int tiles = (sq + L::QT - 1) / L::QT;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_map<T>(&tq, q, D, sq, bh, L::QT) ||
      !encode_map<T>(&tk, k, D, sk, bh, kKT) ||
      !encode_map<T>(&tv, v, D, sk, bh, kKT)) {
    return cudaErrorInvalidValue;
  }
  static bool opted = false;
  cudaError_t err = opt_in(fwd_kernel<T, D, NC, SEGS, DROP, BIAS, QSCALE>,
                           L::BYTES, &opted);
  if (err != cudaSuccess) return err;
  const Params prm{q_ids, kv_ids, out, lse, heads, sq, sk, causal, scale,
                   dr, bias};
  fwd_kernel<T, D, NC, SEGS, DROP, BIAS, QSCALE>
      <<<dim3(bh, tiles), L::THREADS, L::BYTES, stream>>>(tq, tk, tv, prm);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sm90
}  // namespace attn
