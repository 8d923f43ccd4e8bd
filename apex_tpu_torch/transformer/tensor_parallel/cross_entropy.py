"""Vocab-parallel softmax cross entropy at tensor-parallel world size 1.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``,
plain PyTorch as the JAX package's is plain XLA (no TPU kernel).  The math
is kept: fp32 logits, the max subtracted as a constant (no gradient
through it), ``log(sum exp) - target logit``, uniform label smoothing over
the vocab, and targets outside the vocab picking a zero logit.  At world
size 1 the JAX collectives are identities.

``lm_head_cross_entropy`` keeps the JAX auto rule (``FUSED_CE_AUTO_BYTES``,
env ``APEX_TPU_FUSED_CE_BYTES``): at or below 2 GiB of fp32 logits it
takes the two-step path (explicit logits, then the cross entropy), which
this slice ports.  The flagship step (8192 tokens x 32768 vocab x 4 B =
1.07 GB) takes it.  The fused chunked path raises: ROADMAP.md queue A
item 4.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from apex_tpu_torch.transformer import parallel_state

__all__ = [
    "FUSED_CE_AUTO_BYTES",
    "FUSED_CE_DEFAULT_CHUNK",
    "fused_ce_auto",
    "lm_head_cross_entropy",
    "vocab_parallel_cross_entropy",
]

FUSED_CE_DEFAULT_CHUNK = 8192

#: ``fused=None`` picks the fused path above this many bytes of fp32
#: logits (the JAX package's rule and default)
FUSED_CE_AUTO_BYTES = int(
    os.environ.get("APEX_TPU_FUSED_CE_BYTES", str(2 << 30)))


def fused_ce_auto(tokens_local: int, vocab_local: int) -> bool:
    """The ``fused=None`` decision: fp32 logits above
    ``FUSED_CE_AUTO_BYTES`` take the fused chunked path."""
    return tokens_local * vocab_local * 4 > FUSED_CE_AUTO_BYTES


def _check_world_size() -> None:
    world = parallel_state.get_tensor_model_parallel_world_size()
    if world != 1:
        raise NotImplementedError(
            f"cross entropy at tensor-parallel world size {world}: only "
            "world size 1 is ported (ROADMAP.md queue A item 9)")


def vocab_parallel_cross_entropy(
    vocab_parallel_logits: torch.Tensor,
    target: torch.Tensor,
    smoothing: float = 0.0,
) -> torch.Tensor:
    """Per-token CE ``(...)`` in fp32 from logits ``(..., vocab)`` and int
    targets ``(...)``."""
    _check_world_size()
    logits = vocab_parallel_logits.float()
    vocab = logits.shape[-1]
    logits = logits - logits.amax(dim=-1, keepdim=True).detach()
    sum_exp = torch.exp(logits).sum(dim=-1)
    target = target.long()
    in_range = (target >= 0) & (target < vocab)
    local = torch.where(in_range, target, torch.zeros_like(target))
    picked = torch.gather(logits, -1, local[..., None])[..., 0]
    picked = torch.where(in_range, picked, torch.zeros_like(picked))
    if smoothing > 0.0:
        mean_logit = logits.sum(dim=-1) / vocab
        return (torch.log(sum_exp) - (1.0 - smoothing) * picked
                - smoothing * mean_logit)
    return torch.log(sum_exp) - picked


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
    """Per-token CE through a tied LM head ``weight (vocab, hidden)``:
    explicit logits in ``hidden``'s dtype, then
    :func:`vocab_parallel_cross_entropy`.  ``fused=None`` applies the
    auto rule; the fused chunked path is not ported."""
    if fused is None:
        fused = fused_ce_auto(math.prod(hidden.shape[:-1]), weight.shape[0])
    if fused:
        raise NotImplementedError(
            f"the fused chunked LM-head cross entropy (chunk {chunk}) is "
            "not ported yet (ROADMAP.md queue A item 4); at or below "
            f"{FUSED_CE_AUTO_BYTES} bytes of fp32 logits the two-step path "
            "runs")
    logits = torch.matmul(hidden, weight.to(hidden.dtype).t())
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    return vocab_parallel_cross_entropy(logits, targets, smoothing=smoothing)
