"""Softmax cross entropy with label smoothing.

Counterpart of ``apex_tpu/contrib/xentropy/__init__.py``, plain PyTorch
as the JAX package's is XLA: the loss is ``(1-s) * nll(target) + s *
(lse - mean logit)`` over fp32 logits, and a custom backward keeps the
reference kernel's form, ``(softmax - (1-s) * onehot - s/V) * g`` in
fp32, cast to the logits' dtype.  The loss comes back in the logits'
dtype unless ``half_to_float``.  The fused LM-head cross entropy
(``transformer.tensor_parallel.cross_entropy``) smooths the same way.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["softmax_cross_entropy_loss", "SoftmaxCrossEntropyLoss"]


def _loss(x: torch.Tensor, labels: torch.Tensor,
          smoothing: float) -> torch.Tensor:
    """fp32 per-example loss from fp32 logits ``x (..., V)``."""
    m = x.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
    nll = lse - torch.gather(x, -1, labels[..., None])[..., 0]
    if smoothing > 0.0:
        return (1.0 - smoothing) * nll + smoothing * (lse - x.mean(dim=-1))
    return nll


class _SoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing: float, half_to_float: bool):
        labels = labels.long()
        loss = _loss(logits.float(), labels, smoothing)
        ctx.save_for_backward(logits, labels)
        ctx.smoothing = smoothing
        return loss if half_to_float else loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        s = ctx.smoothing
        x = logits.float()
        dx = torch.softmax(x, dim=-1)
        onehot = torch.zeros_like(dx).scatter_(-1, labels[..., None], 1.0)
        dx = (dx - (1.0 - s) * onehot - s / x.shape[-1]) * g.float()[..., None]
        return dx.to(logits.dtype), None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               half_to_float: bool = False) -> torch.Tensor:
    """Per-example smoothed cross entropy: ``logits (..., V)``, integer
    ``labels (...)``; differentiable in ``logits``."""
    return _SoftmaxXent.apply(logits, labels, float(smoothing),
                              bool(half_to_float))


class SoftmaxCrossEntropyLoss:
    """The reference's module form (``smoothing``, ``padding_idx``,
    ``half_to_float``): per-example losses, zero where the label is
    ``padding_idx`` (None keeps every position)."""

    def __init__(self, smoothing: float = 0.0,
                 padding_idx: Optional[int] = 0,
                 half_to_float: bool = False):
        self.smoothing = smoothing
        self.padding_idx = padding_idx
        self.half_to_float = half_to_float

    def __call__(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        losses = softmax_cross_entropy_loss(logits, labels, self.smoothing,
                                            self.half_to_float)
        if self.padding_idx is not None:
            losses = torch.where(labels == self.padding_idx,
                                 torch.zeros_like(losses), losses)
        return losses
