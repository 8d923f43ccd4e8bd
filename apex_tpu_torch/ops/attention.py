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
multiples, since its kernels mask the ragged ends themselves (so the JAX
wrappers' pad segment ids have no counterpart either).

Segment ids ``(b, sq)``/``(b, sk)`` go down every rung to its kernels'
segment instances, and dropout (``dropout_rate`` with a uint32
``dropout_seed``) to their dropout instances.  Every rung and
``mha_reference`` draw the same mask for a seed: :func:`keep_mask` (a
copy of the JAX ``_keep_mask``, with ``mix32`` and ``keep_threshold``)
over the global flattened batch*head index and the absolute query and
key positions.  An additive ``bias`` broadcastable from ``(1|b, 1|h, sq,
sk)`` goes down every rung to its kernels, which add it in fp32 to the
scaled scores before the mask (``_bias`` launch counters).  It is
differentiable by default, as in JAX: a bias whose gradient autograd asks
for runs the dQ kernel's dBias instance on every rung (``_dbias``
counters), its gradient summed into the bias's shape and dtype; with
``bias_requires_grad=False`` (the T5 and contrib callers' constant masks)
its gradient is a hard zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.attention_decode import decode_contiguous
from apex_tpu_torch.ops.attention_flash import checked as flash_checked
from apex_tpu_torch.ops.attention_flash import flash_delta
from apex_tpu_torch.ops.attention_flash import run_bwd as flash_run_bwd
from apex_tpu_torch.ops.attention_flash import run_fwd as flash_run_fwd
from apex_tpu_torch.ops.attention_mid import fmha_mid, mid_seq_threshold
from apex_tpu_torch.ops.attention_short import (
    dropout_spec,
    fmha_short,
    grad_of_bias,
    keep_bias_like,
    keep_mask,
    keep_rows,
    keep_threshold,
    mix32,
    pad_head_dim,
    segment_ids,
    short_seq_threshold,
    visible,
)

__all__ = ["flash_attention", "mha_reference", "keep_mask", "keep_threshold",
           "mix32"]

_NEG_INF = -1e30

#: rung names ``implementation`` takes; "pallas" is the JAX name of the
#: flash rung, and "decode" the paged decode kernel over contiguous K/V
_RUNGS = ("short", "mid", "pallas", "decode")


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
) -> torch.Tensor:
    """Plain attention with an fp32 softmax over ``(b, h, s, d)``, as the
    JAX reference: an fp32 ``bias`` broadcastable to ``(b, h, sq, sk)``
    added to the scaled scores, causal and segment-id masks (masked
    scores -1e30, masked probabilities 0, so a row that sees no key gives
    0), and the probabilities cast to ``v``'s dtype before the second
    product.  With ``dropout_rate`` and a uint32 ``dropout_seed`` the
    probabilities are dropped by :func:`keep_mask` and the kept ones
    divided by ``1 - rate``, as in JAX."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("segment ids must be given for both q and kv")
    drop = dropout_spec("mha_reference", dropout_rate, dropout_seed)
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = (1.0 / d ** 0.5) if sm_scale is None else sm_scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    mask = visible(sq, sk, causal, q_segment_ids, kv_segment_ids,
                   device=q.device)
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
        p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    else:
        p = torch.softmax(s, dim=-1)
    if drop is not None:
        keep = keep_rows(drop, q.shape[:2], sq, sk, q.device)
        # a divisor tensor, not a Python float: CUDA divides by a scalar
        # as a multiply by its reciprocal
        p = torch.where(keep, p / torch.full((), 1.0 - drop[0],
                                             device=p.device), 0.0)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


class _Flash(torch.autograd.Function):
    """``out = attention(q, k, v)`` over ``(b*h, s, d)`` through the flash
    kernels; saves ``(q, k, v, out, lse)`` as the JAX ``_flash_fwd``
    does, the bias as the kernels read it, and the segment ids with their
    ``heads`` and the dropout rate and seed.  The backward takes ``delta =
    rowsum(dout * out)`` once and runs the dK/dV and the dQ kernel on it,
    each replaying the mask and the bias; the bias's gradient comes from
    the dQ kernel's dBias instance under ``bias_requires_grad`` (folded
    from ``(bh, sq, sk)`` into the bias's shape and dtype, as the JAX
    ``_flash_bwd`` folds it) and is a hard zero otherwise."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_ids, kv_ids, heads, rate,
                seed, bias_requires_grad, bias):
        ops = flash_checked("flash_fwd", q, k, v, sm_scale, q_ids, kv_ids,
                            heads, rate, seed, bias)
        out, lse = flash_run_fwd(q, k, v, causal, **ops)
        ctx.save_for_backward(q, k, v, out, lse, ops.pop("slab"))
        ctx.causal, ctx.ops = causal, ops
        keep_bias_like(ctx, bias, bias_requires_grad)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, slab = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(out, dout)
        dk, dv = flash_run_bwd("flash_bwd_dkv", q, k, v, dout, lse, delta,
                               ctx.causal, **ctx.ops, slab=slab)
        dq, g = flash_run_bwd("flash_bwd_dq", q, k, v, dout, lse, delta,
                              ctx.causal, **ctx.ops, slab=slab,
                              dbias=ctx.dbias)
        return (dq, dk, dv) + (None,) * 8 + (grad_of_bias(ctx, g),)


def _flash_attention_kernels(q, k, v, causal, sm_scale, q_ids=None,
                             kv_ids=None, dropout_rate=0.0,
                             dropout_seed=None, bias=None,
                             bias_requires_grad=True):
    """The flash rung over ``(b, h, s, d)``: pad a head dim the kernels do
    not take (as the short rung does), flatten to ``(b*h, s, d)`` (row
    ``b_i * h + h_i``, the dropout hash's ``bh``), run ``_Flash``
    (segment ids stay ``(b, s)``, the bias its ``(1|b, 1|h, sq, sk)``),
    restore the heads."""
    b, h, sq, d = q.shape
    q, k, v, scale = pad_head_dim(q, k, v, sm_scale)
    dp = q.shape[-1]
    flat = lambda x: x.reshape(b * h, x.shape[2], dp)
    out = _Flash.apply(flat(q), flat(k), flat(v), causal, scale, q_ids,
                       kv_ids, h, dropout_rate, dropout_seed,
                       bias_requires_grad, bias)
    return out.reshape(b, h, sq, dp)[..., :d]


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
    dropout_seed=None,
    bias_requires_grad: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Attention over ``(batch, heads, seq, head_dim)``, differentiable in
    q, k and v.

    fp32, bf16 or fp16 inputs with both sequence lengths at most
    ``short_seq_threshold()`` run the short kernel, with the longer one at
    most ``mid_seq_threshold()`` the mid kernel, and longer ones the flash
    kernels (512 and 2048 unless ``APEX_TPU_FMHA_SHORT_MAX_SEQ`` /
    ``APEX_TPU_FMHA_MID_MAX_SEQ`` say otherwise; ``0`` turns a rung off).
    ``implementation`` forces a rung: ``"short"``, ``"mid"`` or
    ``"pallas"`` (the JAX name of the flash rung), or ``"decode"``: the
    paged decode kernel over contiguous K/V
    (:func:`~apex_tpu_torch.ops.attention_decode.decode_contiguous`, a few
    query rows at the cache's tail; plain or causal attention only, not
    differentiable, as in JAX).

    ``block_q``/``block_k`` are accepted for the JAX signature and not
    used: in JAX they are the flash kernel's TPU tiles (512 x 1024 by
    default, clamped for fp32 by a VMEM budget), which say nothing about
    the H100; the CUDA kernels choose their own tiles
    (``csrc/attention_flash.cu``).

    ``q_segment_ids``/``kv_segment_ids`` ``(b, sq)``/``(b, sk)`` integers
    let query i see key j only where their ids are equal (BERT's padding
    and ``contrib.fmha``'s packed varlen batches); every rung takes them.
    ``dropout_rate`` > 0 with a uint32 ``dropout_seed`` (int, numpy or 0-d
    tensor; ``ValueError`` without one) drops probabilities on every rung
    with the same mask.

    ``bias`` is an additive fp32 score bias broadcastable from ``(1|b,
    1|h, sq, sk)`` (fewer dims are leading ones, as in JAX), added to the
    scaled scores before the mask on every rung; a broadcast batch or head
    dim stays broadcast (never expanded per head).  It is differentiable
    by default, as in JAX: when autograd asks for its gradient, every
    rung's backward runs the dQ kernel's dBias instance (the gradient of
    each pair's biased score, ``p * (dp - delta)``, an fp32 ``(b*h, sq,
    sk)`` tensor, 1.07 GB at b=2 h=8 s=4096), summed over the bias's
    broadcast dims into its shape and dtype.  Pass
    ``bias_requires_grad=False`` for a constant mask, as the T5 and
    contrib callers do: its gradient is then a hard zero and the backward
    keeps the instances without dBias.  A row the bias alone masks (-1e30
    on every key) is a uniform mean of V, as JAX's softmax gives, and its
    bias gradient is ``dp - delta`` on every key it sees, as the Pallas
    bodies replay ``exp(s - lse) = 1`` there."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("segment ids must be given for both q and kv")
    dropout_spec("flash_attention", dropout_rate, dropout_seed)
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
    if rung == "decode":
        # explicit only, as in JAX: decode callers hold no trainable bias
        # or segments and never differentiate through the cache
        if (bias is not None or q_segment_ids is not None
                or dropout_rate > 0.0):
            raise ValueError(
                "implementation='decode' supports plain (optionally "
                "causal) attention only — no bias/segments/dropout")
        return decode_contiguous(q, k, v, causal=causal, sm_scale=sm_scale)
    ids = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
               dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    if rung == "short":
        return fmha_short(q, k, v, causal=causal, sm_scale=sm_scale,
                          bias=bias, bias_requires_grad=bias_requires_grad,
                          **ids)
    if rung == "mid":
        return fmha_mid(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias,
                        bias_requires_grad=bias_requires_grad, **ids)
    if rung == "pallas":
        segment_ids("flash_attention", q_segment_ids, kv_segment_ids,
                    q.shape[0], q.shape[2], k.shape[2])
        return _flash_attention_kernels(q, k, v, causal, sm_scale,
                                        q_segment_ids, kv_segment_ids,
                                        dropout_rate, dropout_seed, bias,
                                        bias_requires_grad)
    raise ValueError(f"implementation={implementation!r}: expected None or "
                     f"one of {_RUNGS}")
