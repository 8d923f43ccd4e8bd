"""Global-norm gradient clipping at tensor-parallel world size 1.

Counterpart of ``clip_grad_norm`` in
``apex_tpu/transformer/tensor_parallel/utils.py``, which the JAX trainer's
``--clip-grad`` runs.  At world size 1 every gradient is whole, so the
mesh-aware psums of the JAX version are identities: the norm is the fp32
L2 norm over all gradients, and each gradient is multiplied by
``min(1, max_norm / max(norm, eps))`` cast to its dtype.
"""

from __future__ import annotations

from typing import Iterable

import torch

from apex_tpu_torch.multi_tensor_apply import global_l2norm

__all__ = ["clip_grad_norm"]


@torch.no_grad()
def clip_grad_norm(parameters: Iterable[torch.Tensor], max_norm: float, *,
                   eps: float = 1e-12) -> torch.Tensor:
    """Clip the ``.grad`` of ``parameters`` in place; returns the global
    norm before clipping, a 0-d fp32 device tensor (no host sync)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = global_l2norm(grads)
    clip = torch.clamp(max_norm / torch.clamp(norm, min=eps), max=1.0)
    for g in grads:
        g.mul_(clip.to(g.dtype))
    return norm
