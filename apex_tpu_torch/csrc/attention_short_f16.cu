// The fp16 instances of attention_short.cu's entries: the same source
// built with ATTN_F16 defined, so its dispatch holds the fp16 (dtype 2)
// instances of the Hopper kernels of attention_fwd_sm90.cuh and
// attention_bwd_sm90.cuh and nothing else.  A library of its own, built by
// its own nvcc beside the others (ops/common.py's build), so the build's
// wall stays that of the longest source; the wrappers load it for fp16
// tensors.
//
// Replaces, for fp16 inputs (the opt levels O1-O3):
//   apex_tpu/ops/attention_short.py::_short_fwd_kernel (:149),
//   ::_short_bwd_kernel (:215)
// What bounds it and how it is built: attention_short.cu and the headers.

#define ATTN_F16 1
#include "attention_short.cu"
