"""Contrib tier of the port: the counterparts of ``apex_tpu.contrib``.

Ported so far: ``fmha``, the packed-varlen attention entry (over the
attention kernels' segment-id instances), and ``multihead_attn``, the
self- and encoder-decoder attention modules (over their additive-bias,
segment-id and dropout instances).  The rest of ``apex_tpu.contrib`` is
ROADMAP.md queue A item 9.
"""

__all__ = ["fmha", "multihead_attn"]
