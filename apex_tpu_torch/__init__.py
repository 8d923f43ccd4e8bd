"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu`` for NVIDIA Hopper.

The JAX package ``apex_tpu`` stays the reference; this package mirrors its
module layout (``apex_tpu_torch/ops/attention_decode.py`` answers
``apex_tpu/ops/attention_decode.py``) and replaces each Pallas TPU kernel on
the ported path with a kernel written by hand for the H100 (CUDA C++ under
``csrc/`` or Triton).  Every entry point runs on the GPU unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch versions run.

Ported so far: greedy serving of the GPT model (``models.gpt``,
``serving``) through the layer-norm, short-prefill and paged-decode
kernels.  What is still to come is listed in ``ROADMAP.md``.
"""

__all__ = ["convert", "models", "ops", "serving", "telemetry",
           "transformer", "utils"]
