"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu`` for NVIDIA Hopper.

The JAX package ``apex_tpu`` stays the reference; this package mirrors its
module layout (``apex_tpu_torch/ops/attention_decode.py`` answers
``apex_tpu/ops/attention_decode.py``) and replaces each Pallas TPU kernel on
the ported path with a kernel written by hand for the H100 (CUDA C++ under
``csrc/`` or Triton).  Every entry point runs on the GPU unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch versions run.

Ported so far: greedy serving of the GPT model (``models.gpt``,
``serving``) and its training step at one GPU (``GPTModel.loss``, the
backward, ``optimizers.FusedAdam``, the ``amp`` precision policies and
``examples.gpt_pretrain``), through the layer-norm, short-attention
(forward and backward), mid-attention (forward and backward) and
paged-decode kernels.  What is still to come is listed in ``ROADMAP.md``.
"""

__all__ = ["amp", "convert", "examples", "models", "multi_tensor_apply",
           "ops", "optimizers", "serving", "telemetry", "transformer",
           "utils"]
