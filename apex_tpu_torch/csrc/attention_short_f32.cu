// The fp32 instances of attention_short.cu's entries: the same source
// built with ATTN_F32 defined, so its dispatch holds the fp32 (dtype 0)
// SIMT kernels and nothing else.  A library of its own, built by its own
// nvcc beside the bf16 and fp16 ones (ops/common.py's build), so the
// build's wall is about that of the heaviest third; the wrappers load it
// for fp32 tensors.
//
// Replaces, for fp32 inputs (O0):
//   apex_tpu/ops/attention_short.py::_short_fwd_kernel (:149),
//   ::_short_bwd_kernel (:215)
// What bounds it and how it is built: attention_short.cu and the headers.

#define ATTN_F32 1
#include "attention_short.cu"
