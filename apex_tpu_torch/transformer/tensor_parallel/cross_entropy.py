"""Vocab-parallel softmax cross entropy.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``,
plain PyTorch as the JAX package's is plain XLA (no TPU kernel).  The math
is kept: fp32 logits, the max subtracted as a constant (no gradient
through it), ``log(sum exp) - target logit``, uniform label smoothing over
the global vocab, and targets outside the vocab picking a zero logit.
Over a tensor-parallel group each rank holds the logits (or the LM-head
rows) of its vocab slice, and JAX's three collectives run through
:mod:`~apex_tpu_torch.transformer.tensor_parallel.mappings`: the detached
row max all-reduced with MAX, the sum of exponentials all-reduced, and
the target logit (with smoothing, stacked with the logit sum: one
all-reduce for both) all-reduced, the last two as ``reduce_from`` regions
(identity backward).  The two-step path's hidden goes through
``copy_to``, so its gradient is all-reduced; the fused path's backward
all-reduces ``dx`` itself, as JAX's ``_ce_bwd`` does.  At world size 1
none of these issues a collective.

``lm_head_cross_entropy`` keeps the JAX auto rule (``FUSED_CE_AUTO_BYTES``,
env ``APEX_TPU_FUSED_CE_BYTES``): at or below 2 GiB of fp32 logits it
takes the two-step path (explicit logits, then the cross entropy), above
it the fused chunked path, :func:`vocab_parallel_cross_entropy_from_hidden`
(an ``autograd.Function`` over JAX's ``_ce_fwd_scan`` and ``_ce_bwd``): an
online log-sum-exp over weight slices of ``chunk`` rows whose backward
re-derives each chunk's softmax from the saved row max and sum of
exponentials, so no logits tensor is ever kept.  The flagship step at a
micro-batch of 8 x 1024 (8192 tokens x 32768 vocab x 4 B = 1.07 GB) takes
the two-step path, at 24 x 1024 (3.2 GB) the fused one.  The chunk
products are ``torch.mm`` with fp32 results (``out_dtype`` on the card,
an fp32 product of the upcast operands on the CPU), as JAX's einsums ask
for ``preferred_element_type=float32``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_reduce,
    copy_to_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility

__all__ = [
    "FUSED_CE_AUTO_BYTES",
    "FUSED_CE_DEFAULT_CHUNK",
    "fused_ce_auto",
    "lm_head_cross_entropy",
    "vocab_parallel_cross_entropy",
    "vocab_parallel_cross_entropy_from_hidden",
]

FUSED_CE_DEFAULT_CHUNK = 8192

#: ``fused=None`` picks the fused path above this many bytes of fp32
#: logits: the JAX package's rule and default, set by its TPU readings;
#: the H100's crossover is measured by ``chip_smoke.py`` (train-fused-ce)
#: and recorded in PERF.md, and does not set this constant
FUSED_CE_AUTO_BYTES = int(
    os.environ.get("APEX_TPU_FUSED_CE_BYTES", str(2 << 30)))


def fused_ce_auto(tokens_local: int, vocab_local: int) -> bool:
    """The ``fused=None`` decision: fp32 logits above
    ``FUSED_CE_AUTO_BYTES`` take the fused chunked path."""
    return tokens_local * vocab_local * 4 > FUSED_CE_AUTO_BYTES


def _local_target(target: torch.Tensor, vocab_local: int) -> tuple:
    """``(local ids, in-range mask)`` of global ``target`` ids in this
    rank's vocab slice (a target outside it picks local id 0)."""
    tp = parallel_state.get_tensor_model_parallel_world_size()
    start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
        vocab_local, parallel_state.get_tensor_model_parallel_rank(), tp)
    target = target.long()
    in_range = (target >= start) & (target < end)
    local = torch.where(in_range, target - start, torch.zeros_like(target))
    return local, in_range


def vocab_parallel_cross_entropy(
    vocab_parallel_logits: torch.Tensor,
    target: torch.Tensor,
    smoothing: float = 0.0,
) -> torch.Tensor:
    """Per-token CE ``(...)`` in fp32 from this rank's logits ``(...,
    vocab / tp)`` and int targets ``(...)`` in the global vocab."""
    logits = vocab_parallel_logits.float()
    vocab = logits.shape[-1] * \
        parallel_state.get_tensor_model_parallel_world_size()
    logits = logits - all_reduce(logits.amax(dim=-1, keepdim=True).detach(),
                                 "max")
    sum_exp = reduce_from_tensor_model_parallel_region(
        torch.exp(logits).sum(dim=-1))
    local, in_range = _local_target(target, logits.shape[-1])
    picked = torch.gather(logits, -1, local[..., None])[..., 0]
    picked = torch.where(in_range, picked, torch.zeros_like(picked))
    if smoothing > 0.0:
        # one all-reduce for the target logit and the logit sum
        picked, logit_sum = reduce_from_tensor_model_parallel_region(
            torch.stack([picked, logits.sum(dim=-1)]))
        mean_logit = logit_sum / vocab
        return (torch.log(sum_exp) - (1.0 - smoothing) * picked
                - smoothing * mean_logit)
    picked = reduce_from_tensor_model_parallel_region(picked)
    return torch.log(sum_exp) - picked


def _largest_chunk_divisor(v_local: int, chunk: int) -> int:
    """Largest divisor of ``v_local`` that is <= ``chunk`` (the fused path
    walks equal weight slices: BERT's 30522 walks chunks of 5087)."""
    for d in range(min(chunk, v_local), 0, -1):
        if v_local % d == 0:
            return d
    return 1


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result from operands of one dtype, the
    products exact and summed in fp32 (JAX's
    ``preferred_element_type=float32``): cuBLAS's ``out_dtype`` on a
    16-bit CUDA operand, else an fp32 product of the upcast operands."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk(x, weight, bias, c: int, chunk: int) -> tuple:
    """Weight rows ``c * chunk ...`` cast to ``x``'s dtype and their fp32
    logits ``(n, chunk)``, the bias added in fp32."""
    rows = slice(c * chunk, (c + 1) * chunk)
    w_c = weight[rows].to(x.dtype)
    return w_c, _mm_f32(x, w_c.t()) + bias[rows].float()


class _FusedCE(torch.autograd.Function):
    """Per-token CE from hidden ``x (n, h)`` and this rank's LM-head rows
    ``weight (vocab / tp, h)``: JAX's ``_ce_from_hidden`` (forward
    ``_ce_fwd_scan``, backward ``_ce_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, target, chunk: int, smoothing: float):
        n, vocab = x.shape[0], weight.shape[0]
        local, in_range = _local_target(target, vocab)
        f32 = dict(dtype=torch.float32, device=x.device)
        m = torch.full((n,), -math.inf, **f32)
        se = torch.zeros((n,), **f32)
        tl = torch.zeros((n,), **f32)
        sl = torch.zeros((n,), **f32)
        for c in range(vocab // chunk):
            _, logits = _chunk(x, weight, bias, c, chunk)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            se = se * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            idx = local - c * chunk
            in_chunk = (idx >= 0) & (idx < chunk)
            picked = torch.gather(logits, 1,
                                  idx.clamp(0, chunk - 1)[:, None])[:, 0]
            tl = torch.where(in_chunk, picked, tl)
            if smoothing > 0.0:
                sl = sl + logits.sum(dim=-1)
        tp = parallel_state.get_tensor_model_parallel_world_size()
        global_max = all_reduce(m, "max")
        # at one rank se * exp(m - m) is se, bit for bit
        sum_exp = all_reduce(se * torch.exp(m - global_max))
        picked = torch.where(in_range, tl - global_max, torch.zeros_like(tl))
        if smoothing > 0.0:
            # one all-reduce for the target logit and the logit sum
            picked, sl = all_reduce(torch.stack([picked, sl]))
            mean_logit = sl / (vocab * tp) - global_max
            loss = (torch.log(sum_exp) - (1.0 - smoothing) * picked
                    - smoothing * mean_logit)
        else:
            loss = torch.log(sum_exp) - all_reduce(picked)
        ctx.save_for_backward(x, weight, bias, local, in_range, global_max,
                              sum_exp)
        ctx.chunk, ctx.smoothing = chunk, smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, local, in_range, global_max, sum_exp = \
            ctx.saved_tensors
        chunk, s = ctx.chunk, ctx.smoothing
        vocab = weight.shape[0]
        vocab_global = vocab * \
            parallel_state.get_tensor_model_parallel_world_size()
        gf = g.float()[:, None]
        rows = torch.arange(x.shape[0], device=x.device)
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty(weight.shape, dtype=torch.float32,
                         device=x.device)
        db = torch.empty((vocab,), dtype=torch.float32, device=x.device)
        for c in range(vocab // chunk):
            w_c, logits = _chunk(x, weight, bias, c, chunk)
            # d loss / d logits = softmax - (1-s) * onehot - s/V, times g
            dl = torch.exp(logits - global_max[:, None]) / sum_exp[:, None]
            idx = local - c * chunk
            hit = in_range & (idx >= 0) & (idx < chunk)
            dl[rows[hit], idx[hit]] -= 1.0 - s
            dl = (dl - s / vocab_global) * gf
            d16 = dl.to(x.dtype)
            dx += _mm_f32(d16, w_c)
            dw[c * chunk:(c + 1) * chunk] = _mm_f32(d16.t(), x)
            db[c * chunk:(c + 1) * chunk] = dl.sum(dim=0)
        # every vocab shard holds part of each softmax row: the hidden's
        # gradient is the sum of the shards' parts
        dx = all_reduce(dx)
        return (dx.to(x.dtype), dw.to(weight.dtype), db.to(bias.dtype),
                None, None, None)


def vocab_parallel_cross_entropy_from_hidden(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    target: torch.Tensor,
    chunk: int = FUSED_CE_DEFAULT_CHUNK,
    bias: Optional[torch.Tensor] = None,
    smoothing: float = 0.0,
) -> torch.Tensor:
    """Fused LM head + cross entropy: per-token fp32 losses ``(...)``
    from ``hidden (..., h)``, the tied ``weight (vocab, h)`` and
    ``target (...)``, with the ``(..., vocab)`` logits never
    materialized.  The forward walks ``vocab / chunk`` weight slices with
    an online log-sum-exp and saves only ``x``, the weight, the bias, the
    local target, its in-range mask and the rows' max and sum of
    exponentials; the backward re-derives each slice's softmax, casts
    ``dlogits`` to ``hidden``'s dtype before both products, sums ``dx``
    in fp32 and casts ``dW`` and ``dbias`` to their parameters' dtypes.
    ``bias (vocab,)`` is an optional per-vocab logit bias (BERT's MLM
    head; a zero fp32 one when None), ``smoothing`` uniform label
    smoothing over the vocab.  A vocab that ``chunk`` does not divide
    walks its largest divisor below ``chunk``; when that is under
    ``min(512, vocab)`` the two-step path runs instead, as in JAX.  Over
    a tensor-parallel group ``weight`` (and ``bias``) are this rank's
    vocab rows and ``target`` holds global ids."""
    lead = hidden.shape[:-1]
    if weight.shape[0] % chunk:
        chunk = _largest_chunk_divisor(weight.shape[0], chunk)
        if chunk < min(512, weight.shape[0]):
            return lm_head_cross_entropy(hidden, weight, target, fused=False,
                                         bias=bias, smoothing=smoothing)
    if bias is None:
        bias = torch.zeros((weight.shape[0],), dtype=torch.float32,
                           device=weight.device)
    x = hidden.reshape(-1, hidden.shape[-1])
    return _FusedCE.apply(x, weight, bias, target.reshape(-1), chunk,
                          float(smoothing)).reshape(lead)


def lm_head_cross_entropy(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    targets: torch.Tensor,
    *,
    fused: Optional[bool] = None,
    chunk: int = FUSED_CE_DEFAULT_CHUNK,
    bias: Optional[torch.Tensor] = None,
    smoothing: float = 0.0,
) -> torch.Tensor:
    """Per-token CE through a tied LM head ``weight (vocab, hidden)``,
    the one dispatch of the GPT, BERT and T5 losses: the fused chunked
    path (:func:`vocab_parallel_cross_entropy_from_hidden`) when
    ``fused``, else explicit logits in ``hidden``'s dtype and
    :func:`vocab_parallel_cross_entropy`.  ``fused=None`` applies the
    auto rule (:func:`fused_ce_auto`)."""
    if fused is None:
        fused = fused_ce_auto(math.prod(hidden.shape[:-1]), weight.shape[0])
    if fused:
        return vocab_parallel_cross_entropy_from_hidden(
            hidden, weight, targets, chunk=chunk, bias=bias,
            smoothing=smoothing)
    logits = torch.matmul(copy_to_tensor_model_parallel_region(hidden),
                          weight.to(hidden.dtype).t())
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    return vocab_parallel_cross_entropy(logits, targets, smoothing=smoothing)
