// The fp16 instances of attention_decode.cu's entries: the same source
// built with DECODE_F16 defined, so its dispatch holds the fp16 (dtype 2)
// instances of the paged decode kernels and nothing else: the small
// split kernel (with and without the fused q-RoPE, fp16 or int8 pages),
// the many-row kernel and its ancestor-mask (tree) form, at head dims 64
// and 128.  A library of its own, built by its own nvcc beside the others
// (ops/common.py's build); the wrapper loads it for fp16 queries.
//
// Replaces, for fp16 queries and pages (serving at the opt levels O1-O3):
//   apex_tpu/ops/attention_decode.py::_decode_kernel (:210)
// What bounds it and how it is built: attention_decode.cu.

#define DECODE_F16 1
#include "attention_decode.cu"
