// Mid-sequence attention (512 < s <= 2048) for Hopper (sm_90a): the C
// entries.
//
// Replaces apex_tpu/ops/attention_mid.py::_mid_fwd_kernel, the Pallas TPU
// kernel that streams 256/128-key blocks through VMEM over a sequential
// grid axis with an online softmax and a causal block skip, and
// ::_mid_bwd_kernel, its fused dq/dk/dv backward with the lse cotangent
// folded in (dz = p * (dp - delta + dlse)).
//
// On the H100 the streamed online softmax with a causal tile skip is
// exactly what the shared forward of attention_common.cuh does, so the mid
// entries run that device code: in bf16 the wgmma/TMA kernel of
// attention_fwd_sm90.cuh with 128-row query tiles (two consumer
// warpgroups) and 128-key tiles, 64 * 8 = 512 blocks at the flagship's
// training shape (b = 8, h = 8, s = 1024), heaviest causal tiles first; in
// fp32 one block per (batch*head, 64-row query tile).  The backward is the delta pass (which folds
// dlse in) plus the dK/dV and dQ kernels, no atomics, so its result is the
// same on every run.
//
// What bounds it on the card: at s = 1024 causal, d = 128, bf16, the
// forward moves 4 * s * d * 2 bytes for 2 * 2 * d * s(s+1)/2 flops per
// (b*h), ~256 flop/byte, close to the ~295 flop/byte balance point of the
// H100; the backward is bound by operations.  With segment ids (fmha's
// packed varlen batches at 512 < max_s <= 2048) the entries launch the
// SEGS instances, counted as mid_fwd_seg and mid_bwd_seg; with dropout (the
// flagship trains at s = 1024 with attention dropout 0.1) the DROP
// instances, counted as mid_fwd_drop and mid_bwd_drop; with a bias the
// BIAS instances, with _bias appended.  A bias that is trained (the Pallas
// body's dbias output with the lse cotangent, :326-342, :403-410) adds the
// dQ kernel's DBIAS instance, which writes each pair's fp32 dz (4 bytes a
// pair: 268 MB at the flagship's b = 8, h = 8, s = 1024), counted with
// _dbias in place of _bias.

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
int mid_fwd(const void* q, const void* k, const void* v, const int* q_ids,
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
// q_ids/kv_ids and the bias as for mid_fwd.  dbias: null, or with a bias
// the (bh, sq, sk) fp32 gradient of the biased scores, zero-filled by the
// caller: the dQ kernel's DBIAS instance stores it.
int mid_bwd(const void* q, const void* k, const void* v, const int* q_ids,
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
