"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu`` for NVIDIA Hopper.

The JAX package ``apex_tpu`` stays the reference; this package mirrors its
module layout (``apex_tpu_torch/ops/attention_decode.py`` answers
``apex_tpu/ops/attention_decode.py``) and replaces each Pallas TPU kernel on
the ported path with a kernel written by hand for the H100 (CUDA C++ under
``csrc/`` or Triton).  Every entry point runs on the GPU unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch versions run.

Ported so far: greedy serving of the GPT model (``models.gpt``,
``serving``: monolithic or chunked prefill, the prefix cache, chain and
tree speculative decoding, int8/int4 weight pools, int8 KV pages) and its
training step at one GPU (``GPTModel.loss``, the backward,
``optimizers.FusedAdam``, the ``amp`` precision policies and
``examples.gpt_pretrain``), for the learned-position model and its Llama
mode, with the whole optimizer tail on multi-tensor kernels (the loss
scaler and its skip-step, ``amp.initialize``, the fused optimizers and
the packed fused tail, ``resilience.StepGuard``), and
``transformer.functional.FusedScaleMaskSoftmax``: a
hand-written kernel for each of the JAX package's Pallas kernels.  What
is still to come is listed in ``ROADMAP.md``.  BERT (``models.bert``)
trains and fine-tunes through the attention kernels' segment-id instances
(``examples.bert_finetune``), which also carry the packed-varlen
``contrib.fmha``.  The GPT trains with dropout through ``random`` (JAX's
threefry2x32 PRNG, bit for bit), the hidden-dropout kernel
(``ops.dropout``) and the attention kernels' dropout instances.  A fleet
of serving replicas (``fleet``: routing, failover, the request journal,
disaggregated prefill and decode, the host offload tier) serves on one
GPU over the same step functions.  Training and serving checkpoint,
resume and report through ``checkpoint``, ``resilience`` and
``telemetry``.  apex's layer library is here too: ``normalization``
(``FusedLayerNorm``, ``MixedFusedLayerNorm``, ``FusedRMSNorm`` over the
layer norm kernels), ``mlp``, ``fused_dense``, ``reparameterization``
(weight norm), ``rnn`` (JAX's cells and stacks), ``transformer.utils``,
``testing``, and in ``contrib`` ``layer_norm``, ``groupbn``,
``bottleneck``, ``transducer`` (its joint's dropout the dropout kernel)
and ``sparsity``.  As in JAX, ``normalization``, ``fused_dense``,
``mlp``, ``rnn`` and ``reparameterization`` are imported with the
package; the rest on first import.
"""

from apex_tpu_torch import normalization
from apex_tpu_torch import fused_dense
from apex_tpu_torch import mlp
from apex_tpu_torch import rnn
from apex_tpu_torch import reparameterization

__all__ = ["amp", "checkpoint", "contrib", "convert", "data", "examples",
           "fleet", "fp16_utils", "fused_dense", "mlp", "models",
           "multi_tensor_apply", "normalization", "ops", "optimizers",
           "parallel", "random", "reparameterization", "resilience", "rnn",
           "serving", "telemetry", "testing", "transformer", "utils"]
