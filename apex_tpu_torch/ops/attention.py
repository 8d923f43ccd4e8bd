"""Attention: the reference math and the dispatch ladder.

Counterpart of ``apex_tpu/ops/attention.py``.  ``mha_reference`` is the
plain attention the JAX package checks its kernels against.
``flash_attention`` is the entry the model calls; its ladder has three
rungs, all differentiable: the short kernel (``ops/attention_short.py``)
while both lengths are at most ``short_seq_threshold()``, the mid kernel
(``ops/attention_mid.py``) up to ``mid_seq_threshold()``, and the flash
kernels (``ops/attention_flash.py``) above it.  The boundaries 512 and
2048 (env-overridable, as in JAX) are the JAX package's; they were
measured on a TPU, not on the H100 (PERF.md records the H100's readings),
and its fp32-to-XLA window (``FLASH_FP32_XLA_MAX_SEQ``) is not copied.

``_Flash`` is the counterpart of the JAX ``_flash`` custom_vjp and
``_flash_attention_kernels`` of ``_flash_attention_pallas``: both work on
the flattened ``(b*h, s, d)`` layout.  The port needs no padding to block
multiples, since its kernels mask the ragged ends themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.attention_flash import (
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_delta,
    flash_fwd,
)
from apex_tpu_torch.ops.attention_mid import fmha_mid, mid_seq_threshold
from apex_tpu_torch.ops.attention_short import fmha_short, short_seq_threshold

__all__ = ["flash_attention", "mha_reference"]

_NEG_INF = -1e30

#: rung names ``implementation`` takes; "pallas" is the JAX name of the
#: flash rung
_RUNGS = ("short", "mid", "pallas")


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


class _Flash(torch.autograd.Function):
    """``out = attention(q, k, v)`` over ``(b*h, s, d)`` through the flash
    kernels; saves ``(q, k, v, out, lse)`` as the JAX ``_flash_fwd``
    does.  The backward takes ``delta = rowsum(dout * out)`` once and runs
    the dK/dV and the dQ kernel on it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None


def _flash_attention_kernels(q, k, v, causal, sm_scale):
    """The flash rung over ``(b, h, s, d)``: flatten to ``(b*h, s, d)``,
    run ``_Flash``, restore the heads."""
    b, h, sq, d = q.shape
    flat = lambda x: x.reshape(b * h, x.shape[2], d)
    out = _Flash.apply(flat(q), flat(k), flat(v), causal, sm_scale)
    return out.reshape(b, h, sq, d)


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
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Attention over ``(batch, heads, seq, head_dim)``, differentiable in
    q, k and v.

    fp32 or bf16 inputs with both sequence lengths at most
    ``short_seq_threshold()`` run the short kernel, with the longer one at
    most ``mid_seq_threshold()`` the mid kernel, and longer ones the flash
    kernels (512 and 2048 unless ``APEX_TPU_FMHA_SHORT_MAX_SEQ`` /
    ``APEX_TPU_FMHA_MID_MAX_SEQ`` say otherwise; ``0`` turns a rung off).
    ``implementation`` forces a rung: ``"short"``, ``"mid"`` or
    ``"pallas"`` (the JAX name of the flash rung).

    ``block_q``/``block_k`` are accepted for the JAX signature and not
    used: in JAX they are the flash kernel's TPU tiles (512 x 1024 by
    default, clamped for fp32 by a VMEM budget), which say nothing about
    the H100; the CUDA kernels choose their own tiles
    (``csrc/attention_flash.cu``).  Bias, segment ids and dropout are not
    ported yet."""
    if bias is not None or q_segment_ids is not None \
            or kv_segment_ids is not None or dropout_rate > 0.0:
        raise NotImplementedError(
            "attention bias, segment ids and dropout are not ported yet "
            "(ROADMAP.md queue B item 2)")
    rung = implementation
    if rung is None:
        sq, sk = q.shape[2], k.shape[2]
        thr = short_seq_threshold()
        if sq <= thr and sk <= thr:
            rung = "short"
        elif max(sq, sk) <= mid_seq_threshold():
            rung = "mid"
        else:
            rung = "pallas"
    if rung == "short":
        return fmha_short(q, k, v, causal=causal, sm_scale=sm_scale)
    if rung == "mid":
        return fmha_mid(q, k, v, causal=causal, sm_scale=sm_scale)
    if rung == "pallas":
        return _flash_attention_kernels(q, k, v, causal, sm_scale)
    raise ValueError(f"implementation={implementation!r}: expected None or "
                     f"one of {_RUNGS}")
