// The fp16 instances of dequant_matmul.cu's entry: the same source built
// with DEQUANT_F16 defined, so its dispatch holds the fp16-x (dtype 2)
// instances and nothing else: dequant_decode (m <= 8, the k split merged
// in the same launch), dequant_wgmma on .f32.f16.f16 products with the
// weights split into fp16 hi + lo after a power-of-two scaling, and
// dequant_tiled over int4 weights whose n / 2 is not a multiple of 16.  A
// library of its own, built by its own nvcc beside the others
// (ops/common.py's build); the wrapper loads it for fp16 x.
//
// Replaces, for fp16 activations (serving at the opt levels O1-O3):
//   apex_tpu/ops/dequant_matmul.py::_int8_kernel (:97), ::_int4_kernel (:107)
// What bounds it and how it is built: dequant_matmul.cu.

#define DEQUANT_F16 1
#include "dequant_matmul.cu"
