"""Attention: the reference math and the dispatch ladder.

Counterpart of ``apex_tpu/ops/attention.py``.  ``mha_reference`` is the
plain attention the JAX package checks its kernels against.
``flash_attention`` is the entry the model calls; its ladder has two
rungs so far, both differentiable: the short kernel
(``ops/attention_short.py``) up to ``FMHA_SHORT_MAX_SEQ`` and the mid
kernel (``ops/attention_mid.py``) up to ``mid_seq_threshold()``.  Longer
sequences raise: the flash rung is ROADMAP.md queue B item 1.  The
boundaries 512 and 2048 are the JAX package's; they were measured on a
TPU, not on the H100 (PERF.md records a first short-vs-mid reading), and
its fp32-to-XLA window (``FLASH_FP32_XLA_MAX_SEQ``) is not copied.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.attention_mid import fmha_mid, mid_seq_threshold
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
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Attention over ``(batch, heads, seq, head_dim)``, differentiable in
    q, k and v.

    fp32 or bf16 inputs with both sequence lengths at most
    ``FMHA_SHORT_MAX_SEQ`` run the short kernel, up to
    ``mid_seq_threshold()`` the mid kernel (512 and 2048, the JAX
    package's boundaries, not crossovers measured on the H100).  Bias,
    segment ids and dropout are not ported yet.  ``implementation``
    forces a rung (``"short"`` or ``"mid"``), as the JAX entry does."""
    if bias is not None or q_segment_ids is not None \
            or kv_segment_ids is not None or dropout_rate > 0.0:
        raise NotImplementedError(
            "attention bias, segment ids and dropout are not ported yet "
            "(ROADMAP.md queue B item 2)")
    rung = implementation
    if rung is None:
        s = max(q.shape[2], k.shape[2])
        if s > mid_seq_threshold():
            raise NotImplementedError(
                f"sequence length {s} > {mid_seq_threshold()}: the flash "
                "attention kernels are not ported yet (ROADMAP.md queue B "
                "item 1)")
        rung = "short" if s <= FMHA_SHORT_MAX_SEQ else "mid"
    if rung == "short":
        return fmha_short(q, k, v, causal=causal, sm_scale=sm_scale)
    if rung == "mid":
        return fmha_mid(q, k, v, causal=causal, sm_scale=sm_scale)
    raise NotImplementedError(
        f"implementation={implementation!r}: the port has the short and mid "
        "rungs; the flash rung is ROADMAP.md queue B item 1")
