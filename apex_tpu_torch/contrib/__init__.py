"""Contrib tier of the port: the counterparts of ``apex_tpu.contrib``.

Ported so far: ``fmha``, the packed-varlen attention entry (over the
attention kernels' segment-id instances), ``multihead_attn``, the
self- and encoder-decoder attention modules (over their additive-bias,
segment-id and dropout instances), and ``xentropy``, the label-smoothed
softmax cross entropy (plain PyTorch, as JAX's is XLA).  The rest of
``apex_tpu.contrib`` is ROADMAP.md queue A item 10 (``bottleneck`` and
``groupbn`` among it, ResNet's contrib kin).
"""

__all__ = ["fmha", "multihead_attn", "xentropy"]
