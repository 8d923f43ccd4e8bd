"""Broadcast batch data from tensor-parallel rank 0.

Counterpart of ``apex_tpu/transformer/tensor_parallel/data.py``, whose
``broadcast_data`` replaces every leaf with tp rank 0's copy by a masked
``psum``.  Here each tensor leaf of ``tree`` (nested dicts, lists and
tuples) is broadcast from the group's first rank; the result is a new
tree, the same on every rank.  Over one rank it is ``tree`` itself.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import group_size

__all__ = ["broadcast_data"]


def broadcast_data(tree: Any, group=None) -> Any:
    """Every tensor leaf of ``tree`` as the group's rank 0 holds it
    (default: the tensor-parallel group)."""
    if group_size(group) == 1:
        return tree
    if group is None:
        group = parallel_state.get_tensor_model_parallel_group()
    src = dist.get_global_rank(group, 0)

    def bcast(x):
        if isinstance(x, dict):
            return type(x)((k, bcast(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(bcast(v) for v in x)
        out = torch.as_tensor(x).contiguous().clone()
        dist.broadcast(out, src=src, group=group)
        return out

    return bcast(tree)
