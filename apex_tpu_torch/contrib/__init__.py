"""Contrib tier of the port: the counterparts of ``apex_tpu.contrib``.

Ported so far: ``fmha``, the packed-varlen attention entry (over the
attention kernels' segment-id instances).  The rest of ``apex_tpu.contrib``
is ROADMAP.md queue A items 3 (``multihead_attn``) and 9.
"""

__all__ = ["fmha"]
