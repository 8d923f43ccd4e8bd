"""Vocab ranges, tensor splits and model-parallel gradient clipping.

Counterpart of ``apex_tpu/transformer/tensor_parallel/utils.py``.
:func:`clip_grad_norm` is the JAX trainer's ``--clip-grad``, aware of
the tensor-parallel shards as JAX's is of its specs: a parameter a layer
shards (marked ``tensor_model_parallel`` by
:mod:`~apex_tpu_torch.transformer.tensor_parallel.layers`) holds one
shard on each rank, so its squares are summed over the group; every other
parameter (the norms, the position table, a row-parallel bias) is the
same on every rank and counts once.  The fp32 squares come from one
``multi_tensor_l2norm`` launch for each class of parameter, then one
all-reduce of the sharded class's square; each gradient is multiplied by
``min(1, max_norm / max(norm, eps))`` cast to its dtype (one
``multi_tensor_scale`` launch a dtype, in place).  At world size 1 every
gradient is one class and there is no all-reduce: one norm launch, as
before tensor parallelism.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_reduce,
    group_size,
)

__all__ = ["VocabUtility", "split_tensor_along_last_dim", "clip_grad_norm"]


def split_tensor_along_last_dim(x: torch.Tensor,
                                num_partitions: int) -> Sequence:
    """The last dim of ``x`` in ``num_partitions`` equal views."""
    last = x.shape[-1]
    if last % num_partitions != 0:
        raise ValueError(
            f"last dim {last} not divisible by num_partitions {num_partitions}"
        )
    return torch.split(x, last // num_partitions, dim=-1)


class VocabUtility:
    """Which ``[first, last)`` vocab slice a tensor-parallel rank owns."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
        per_partition_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(
        global_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        if global_vocab_size % world_size != 0:
            raise ValueError(
                f"vocab size {global_vocab_size} not divisible by tp {world_size}"
            )
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            global_vocab_size // world_size, rank, world_size
        )


@torch.no_grad()
def clip_grad_norm(parameters: Iterable[torch.Tensor], max_norm: float, *,
                   eps: float = 1e-12) -> torch.Tensor:
    """Clip the ``.grad`` of ``parameters`` in place; returns the global
    norm before clipping, a 0-d fp32 device tensor (no host sync), the
    same on every tensor-parallel rank."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros((), dtype=torch.float32)
    grads = [p.grad for p in params]
    if group_size() == 1:
        norm = mt.l2norm(grads).total
    else:
        sharded: List[torch.Tensor] = [
            p.grad for p in params
            if getattr(p, "tensor_model_parallel", False)]
        replicated = [p.grad for p in params
                      if not getattr(p, "tensor_model_parallel", False)]
        sq = grads[0].new_zeros((), dtype=torch.float32)
        if sharded:
            sq = all_reduce(mt.l2norm(sharded).total.square())
        if replicated:
            sq = sq + mt.l2norm(replicated).total.square()
        norm = sq.sqrt()
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
