"""Multi-tensor reductions over lists of tensors.

Counterpart of ``apex_tpu/multi_tensor_apply``, whose reductions are
plain XLA math, not Pallas kernels; here they are plain PyTorch.  Only
the global L2 norm that ``FusedAdam(max_grad_norm=)`` and the trainer's
``--clip-grad`` use is ported so far (the rest of the module is ROADMAP.md
queue A item 10).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["global_l2norm"]


def global_l2norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all floating tensors together, with fp32
    accumulation as the JAX ``multi_tensor_l2norm`` sums it: each
    tensor's sum of squares in fp32, then the square root of their sum.
    A 0-d fp32 tensor on the tensors' device (no host synchronisation)."""
    leaves = [t for t in tensors if t.is_floating_point()]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = [torch.sum(torch.square(t.float())) for t in leaves]
    return torch.sqrt(torch.stack(sq).sum())
