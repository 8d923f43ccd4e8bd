"""Global-norm gradient clipping at tensor-parallel world size 1.

Counterpart of ``clip_grad_norm`` in
``apex_tpu/transformer/tensor_parallel/utils.py``, which the JAX trainer's
``--clip-grad`` runs.  At world size 1 every gradient is whole, so the
mesh-aware psums of the JAX version are identities: the norm is the fp32
L2 norm over all gradients (one ``multi_tensor_l2norm`` launch on the
card), and each gradient is multiplied by ``min(1, max_norm / max(norm,
eps))`` cast to its dtype (one ``multi_tensor_scale`` launch, in place).
"""

from __future__ import annotations

from typing import Iterable

import torch

from apex_tpu_torch.ops import multi_tensor as mt

__all__ = ["clip_grad_norm"]


@torch.no_grad()
def clip_grad_norm(parameters: Iterable[torch.Tensor], max_norm: float, *,
                   eps: float = 1e-12) -> torch.Tensor:
    """Clip the ``.grad`` of ``parameters`` in place; returns the global
    norm before clipping, a 0-d fp32 device tensor (no host sync)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norm = mt.l2norm(grads).total
    clip = torch.clamp(norm.new_full((), max_norm)
                       / torch.clamp(norm, min=eps), max=1.0)
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for dtype, gs in by_dtype.items():
        # JAX multiplies in the gradient's dtype: g * clip.astype(g.dtype)
        factor = clip if dtype == torch.float32 else clip.to(dtype).float()
        mt.scale(gs, factor, out=gs)
    return norm
