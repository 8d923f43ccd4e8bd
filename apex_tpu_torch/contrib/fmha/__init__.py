"""FMHA: fused multi-head attention with a varlen (``cu_seqlens``) API.

Counterpart of ``apex_tpu/contrib/fmha/__init__.py`` (the reference's
``apex.contrib.fmha``): ``qkv`` packed as ``(total_tokens, 3, heads,
head_dim)`` with ``cu_seqlens`` prefix offsets.  As in the JAX package,
varlen is segment-id masking inside one padded batch: the packed tokens
are scattered into ``(b, max_seq_len)``, real tokens are segment 0, query
padding -1 and key padding -2 (so a padded query sees no key and gives 0,
and a padded key is seen by no query), one ``flash_attention`` runs over
the batch, and the real tokens are gathered back.  The attention ladder
picks the rung by ``max_seq_len`` (the short kernel up to 512, the mid
kernel up to 2048, the flash kernels above), each through its segment-id
instance; ``implementation`` forces one.  Differentiable in ``qkv``.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.attention import flash_attention

__all__ = ["fmha", "FMHA"]

#: the segment ids of query and key padding (real tokens are 0)
PAD_QUERY_SEGMENT = -1
PAD_KEY_SEGMENT = -2


def fmha(
    qkv: torch.Tensor,
    cu_seqlens: torch.Tensor,
    max_seq_len: int,
    causal: bool = False,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Packed-varlen attention.  ``qkv (total_tokens, 3, heads,
    head_dim)``; ``cu_seqlens (b + 1,)`` integer prefix sums from 0 to
    ``total_tokens``, each sequence at most ``max_seq_len`` tokens.
    Returns ``(total_tokens, heads, head_dim)`` in qkv's dtype."""
    if qkv.ndim != 4 or qkv.shape[1] != 3:
        raise ValueError(f"qkv must be (total_tokens, 3, heads, head_dim), "
                         f"got {tuple(qkv.shape)}")
    total, _, heads, d = qkv.shape
    cu = torch.as_tensor(cu_seqlens, device=qkv.device).long()
    b = cu.shape[0] - 1
    lengths = cu[1:] - cu[:-1]
    if b < 1 or int(cu[-1]) != total or int(lengths.min()) < 0 \
            or int(lengths.max()) > max_seq_len:
        raise ValueError(
            f"cu_seqlens must rise from 0 to {total} in steps of at most "
            f"max_seq_len={max_seq_len}, got {cu.tolist()}")

    # scatter the packed tokens into a (b, max_seq_len) padded batch
    tok = torch.arange(total, device=qkv.device)
    seg = torch.searchsorted(cu[1:], tok, right=True)
    batch_idx = seg * max_seq_len + (tok - cu[seg])
    padded = qkv.new_zeros((b * max_seq_len, 3, heads, d)).index_copy(
        0, batch_idx, qkv).reshape(b, max_seq_len, 3, heads, d)
    q, k, v = (padded[:, :, i].transpose(1, 2) for i in range(3))

    valid = (torch.arange(max_seq_len, device=qkv.device)[None, :]
             < lengths[:, None])
    q_seg = torch.where(valid, 0, PAD_QUERY_SEGMENT).to(torch.int32)
    kv_seg = torch.where(valid, 0, PAD_KEY_SEGMENT).to(torch.int32)
    out = flash_attention(q, k, v, causal=causal, q_segment_ids=q_seg,
                          kv_segment_ids=kv_seg,
                          implementation=implementation)
    out = out.transpose(1, 2).reshape(b * max_seq_len, heads, d)
    return out[batch_idx]


class FMHA:
    """Module wrapper (the reference's ``FMHA``): ``FMHA(causal,
    implementation)(qkv, cu_seqlens, max_s)``."""

    def __init__(self, causal: bool = False,
                 implementation: Optional[str] = None):
        self.causal = causal
        self.implementation = implementation

    def __call__(self, qkv, cu_seqlens, max_s):
        return fmha(qkv, cu_seqlens, max_s, causal=self.causal,
                    implementation=self.implementation)
