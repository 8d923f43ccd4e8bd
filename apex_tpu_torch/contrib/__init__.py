"""Contrib tier of the port: the counterparts of ``apex_tpu.contrib``.

Ported: ``fmha``, the packed-varlen attention entry (over the attention
kernels' segment-id instances); ``multihead_attn``, the self- and
encoder-decoder attention modules (over their additive-bias, segment-id
and dropout instances); ``xentropy``, the label-smoothed softmax cross
entropy; ``layer_norm``, ``FastLayerNorm`` (the layer norm kernels);
``groupbn``, the NHWC batch norm with the fused residual add and ReLU;
``bottleneck``, the ResNet bottleneck block; ``transducer``, the RNN-T
joint (its dropout the dropout kernel) and loss; and ``sparsity``, ASP's
2:4 masks.  Plain PyTorch where JAX's is XLA.  ``optimizers`` (the
distributed optimizers) is ROADMAP.md queue A item 9, as are
``bottleneck.SpatialBottleneck`` and ``groupbn``'s ``bn_group > 1``,
which raise.
"""

__all__ = ["bottleneck", "fmha", "groupbn", "layer_norm", "multihead_attn",
           "sparsity", "transducer", "xentropy"]
