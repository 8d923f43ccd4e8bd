// Short-sequence attention (s <= 512) for Hopper (sm_90a): the C entries.
//
// Replaces apex_tpu/ops/attention_short.py::_short_fwd_kernel, the
// single-pass Pallas TPU kernel that holds a whole (s <= 512) K/V sequence
// in VMEM, and ::_short_bwd_kernel, its fused dq/dk/dv backward.  The
// device code (a forward that streams 128-key tiles with an online softmax,
// bf16 through the wgmma/TMA kernel of attention_fwd_sm90.cuh and fp32
// through 64-key SIMT tiles, and a delta pass plus separate dK/dV and dQ
// kernels for the backward) is shared with the mid rung and described in
// attention_common.cuh: the whole-sequence pass of the TPU kernel does not
// fit 227 KB of shared memory at s = 512, d = 128, and the TPU backward's
// sequential accumulation does not carry over to blocks that run in no
// order.
//
// What bounds it on the card: at s = 512 causal, one (b*h) slice does
// 2 * 2 * d * s(s+1)/2 flops over 4 * s * d * 2 bytes, ~130 flop/byte,
// under the H100's ~295 flop/byte bf16 balance point, so the least time is
// set by the bytes moved.
//
// With segment ids (BERT's padding, fmha's packed varlen batches) the same
// entries launch the SEGS instances of attention_common.cuh; the wrappers
// count them as short_fwd_seg and short_bwd_seg.  At BERT-large's training
// shape (b = 16, h = 16, s = 512, d = 64, not causal) a (b*h) slice does
// 4 * d * s^2 flops over 4 * s * d * 2 bytes, ~256 flop/byte, still under
// the balance point; nothing is skipped on the ids, so the work is that of
// a full mask whatever the padding.  With dropout the entries launch the
// DROP instances (short_fwd_drop, short_bwd_drop; with ids as well,
// short_fwd_seg_drop, short_bwd_seg_drop).  With an additive bias
// (contrib attention's attn_mask) they launch the BIAS instances, which
// read it once per pair and so add 4 bytes a stored element to the bytes
// moved; the wrappers count those launches with _bias appended.  For a bias
// that is trained (the Pallas body's dbias output, :227-294) the backward
// launches the dQ kernel's DBIAS instance, which also writes each pair's
// fp32 dz, 4 bytes a pair of every row (b*h*sq*sk*4 bytes, 134 MB at
// Transformer-big's decoder, b = 32, h = 16, s = 256), summed by the
// wrapper over the bias's broadcast dims; counted with _dbias in place of
// _bias.

// The bf16 forward's query tile: one consumer warpgroup (64 rows).  At the
// serving prefill (b = 1, h = 8, s = 512) 128-row tiles give 32 blocks for
// 132 SMs; 64-row tiles ran faster there and at BERT-large's b = 16,
// h = 16, d = 64 (python -m apex_tpu_torch.tools.fwd_rows, PERF.md).
#define ATTN_FWD_WARPGROUPS 1
// The bf16 backward's blocks: one consumer warpgroup (64 keys of a dK/dV
// block, 64 query rows of a dQ block).  At BERT-large's b = 16, h = 16,
// d = 64 they ran 0.1116 / 0.0906 ms against 0.1228 / 0.0964 with two, and
// within 5% of two at b = 8, h = 8, s = 512, d = 128 (python -m
// apex_tpu_torch.tools.bwd_rows, PERF.md).
#define ATTN_BWD_WARPGROUPS 1

#include "attention_common.cuh"

extern "C" {

// dtype: 1 = bf16 here; 0 = fp32 and 2 = fp16 in the libraries built from
// the _f32 and _f16 sources, each taking its own only.  q_ids/kv_ids: both null, or (bh / heads, sq)
// and (bh / heads, sk) int32 segment ids.  bias: null, or an fp32 additive
// score bias whose (sq, sk) slab for row bh = b_i * heads + h_i starts
// b_i * bias_stride_b + h_i * bias_stride_h elements in (a stride of 0 on a
// broadcast dim).  seed, keep_threshold, inv_keep: the dropout hash's
// uint32 seed and threshold and the fp32 1 / (1 - rate); inv_keep = 0
// launches the instance without dropout.  Returns a cudaError_t code (0 =
// success).
int short_fwd(const void* q, const void* k, const void* v, const int* q_ids,
              const int* kv_ids, const float* bias, void* out, float* lse, int bh,
              int heads, int sq, int sk, int d, int dtype, int causal,
              int bias_stride_b, int bias_stride_h, float scale, unsigned seed,
              unsigned keep_threshold, float inv_keep, void* stream) {
  return attn::fwd(q, k, v, q_ids, kv_ids, out, lse, bh, heads, sq, sk, d,
                   dtype, causal, scale,
                   attn::Dropout{seed, keep_threshold, inv_keep},
                   attn::Bias{bias, bias_stride_b, bias_stride_h}, stream);
}

// delta: (bh, sq) fp32 scratch; dlse: (bh, sq) fp32 lse cotangent or null;
// q_ids/kv_ids and the bias as for short_fwd.  dbias: null, or with a bias
// the (bh, sq, sk) fp32 gradient of the biased scores, zero-filled by the
// caller: the dQ kernel's DBIAS instance stores it.
int short_bwd(const void* q, const void* k, const void* v, const int* q_ids,
              const int* kv_ids, const float* bias, const void* out,
              const void* dout, const float* lse, const float* dlse, float* delta,
              void* dq, void* dk, void* dv, float* dbias, int bh, int heads,
              int sq, int sk, int d, int dtype, int causal, int bias_stride_b,
              int bias_stride_h, float scale, unsigned seed,
              unsigned keep_threshold, float inv_keep, void* stream) {
  return attn::bwd(q, k, v, q_ids, kv_ids, out, dout, lse, dlse, delta, dq,
                   dk, dv, dbias, bh, heads, sq, sk, d, dtype, causal, scale,
                   attn::Dropout{seed, keep_threshold, inv_keep},
                   attn::Bias{bias, bias_stride_b, bias_stride_h}, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
