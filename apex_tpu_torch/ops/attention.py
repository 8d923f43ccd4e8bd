"""Attention: the reference math and the forward dispatch ladder.

Counterpart of ``apex_tpu/ops/attention.py``.  ``mha_reference`` is the
plain attention the JAX package checks its kernels against.
``flash_attention`` is the entry the model calls; its ladder has one
rung so far, the short kernel (``ops/attention_short.py``), for
sequences up to ``FMHA_SHORT_MAX_SEQ``.  Longer sequences raise: the mid
and flash rungs are ROADMAP.md queue B items 4-5, and the JAX package's
crossovers (``FMHA_SHORT_MAX_SEQ``, ``FMHA_MID_MAX_SEQ``,
``FLASH_FP32_XLA_MAX_SEQ``) were measured on a TPU, so none is copied.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.attention_short import FMHA_SHORT_MAX_SEQ, fmha_short

__all__ = ["flash_attention", "mha_reference"]

_NEG_INF = -1e30


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention with an fp32 softmax over ``(b, h, s, d)``; the
    probabilities are cast to ``v``'s dtype before the second product, as
    in the JAX reference."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = (1.0 / d ** 0.5) if sm_scale is None else sm_scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, _NEG_INF)
        p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    else:
        p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Attention over ``(batch, heads, seq, head_dim)``, forward only.

    fp32 or bf16 inputs with both sequence lengths at most
    ``FMHA_SHORT_MAX_SEQ`` (512: the window the short kernel is built and
    tested for, not a crossover measured on the H100) run the short
    kernel.  Bias, segment ids and dropout are not ported yet."""
    if bias is not None or q_segment_ids is not None \
            or kv_segment_ids is not None or dropout_rate > 0.0:
        raise NotImplementedError(
            "attention bias, segment ids and dropout are not ported yet "
            "(ROADMAP.md queue B item 2)")
    if max(q.shape[2], k.shape[2]) > FMHA_SHORT_MAX_SEQ:
        raise NotImplementedError(
            f"sequence length {max(q.shape[2], k.shape[2])} > "
            f"{FMHA_SHORT_MAX_SEQ}: the mid and flash attention kernels are "
            "not ported yet (ROADMAP.md queue B items 4-5)")
    return fmha_short(q, k, v, causal=causal, sm_scale=sm_scale)
