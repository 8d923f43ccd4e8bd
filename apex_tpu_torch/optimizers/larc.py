"""LARC: layer-wise adaptive rate clipping or scaling.

Counterpart of ``apex_tpu/optimizers/larc.py``: :func:`larc_transform`
rescales each gradient so that an optimizer stepping at its own ``lr``
moves at the LARC rate,

    local_lr = trust_coefficient * |p| / (|g| + weight_decay * |p| + eps)
    clip:  g <- (g + wd p) * min(local_lr / lr, 1)
    scale: g <- (g + wd p) * local_lr / lr

(``local_lr = lr`` where either norm is 0).  The norms of the parameters
and of the gradients are each one launch of ``multi_tensor_l2norm`` on
the card; the rest is plain PyTorch, as JAX's is XLA.  :class:`LARC`
wraps a port optimizer and rescales its gradients in place before its
``step``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.ops import multi_tensor as mt

__all__ = ["larc_transform", "LARC"]


def larc_transform(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor], lr: float,
                   trust_coefficient: float = 0.02, clip: bool = True,
                   eps: float = 1e-8, weight_decay: float = 0.0
                   ) -> List[torch.Tensor]:
    """The LARC-adjusted gradients (new tensors, each in its gradient's
    dtype)."""
    params, grads = list(params), list(grads)
    if not grads:
        return []
    p32 = [p.detach().float() for p in params]
    g32 = [g.float() for g in grads]
    pn = mt.l2norm(p32, per_tensor=True).per_tensor
    gn = mt.l2norm(g32, per_tensor=True).per_tensor
    local = trust_coefficient * pn / (gn + weight_decay * pn + eps)
    local = torch.where((pn > 0) & (gn > 0), local, torch.full_like(pn, lr))
    # JAX divides by the constant lr as XLA compiles it: a multiply by
    # its fp32 reciprocal
    factor = local * float(np.float32(1.0) / np.float32(lr))
    if clip:
        factor = torch.clamp(factor, max=1.0)
    out = []
    for i, (p, g) in enumerate(zip(p32, g32)):
        out.append(((g + weight_decay * p) * factor[i]).to(grads[i].dtype))
    return out


class LARC:
    """Wraps a port optimizer: :meth:`step` rescales each group's
    gradients in place by :func:`larc_transform` (the group's ``lr`` and
    ``weight_decay``), then steps the optimizer."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8):
        self.optimizer = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    @torch.no_grad()
    def step(self, closure=None,
             grads_finite: Optional[torch.Tensor] = None):
        for group in self.optimizer.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            new = larc_transform(
                params, [p.grad for p in params], lr=group["lr"],
                trust_coefficient=self.trust_coefficient, clip=self.clip,
                eps=self.eps, weight_decay=group.get("weight_decay", 0.0))
            for p, g in zip(params, new):
                p.grad.copy_(g)
        return self.optimizer.step(closure, grads_finite=grads_finite)
