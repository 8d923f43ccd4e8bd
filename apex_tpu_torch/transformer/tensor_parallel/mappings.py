"""The tensor-parallel regions, as ``torch.autograd.Function``s.

Counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``:

=========  ==================  ==================
region     forward             backward
=========  ==================  ==================
copy_to    identity            all-reduce
reduce     all-reduce          identity
scatter    split (my chunk)    all-gather
gather     all-gather          split (my chunk)
=========  ==================  ==================

JAX gets the backward column from the transposes of its collectives
under ``shard_map``'s vma typing; the port runs one process a rank, so the
rules are written out here, as apex's own Megatron functions are.  Every
collective of the port goes through this module: :func:`all_reduce`,
:func:`all_gather_invariant` and the regions, over the tensor-parallel
group of :mod:`~apex_tpu_torch.transformer.parallel_state` unless a
``group`` is given.  Over a group of one rank every region is the
identity (the split and the gather keep the whole tensor) and no
``torch.distributed`` call is made, so the world-size-1 paths launch
exactly what they did before tensor parallelism, as JAX skips a
one-device collective at trace time.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "all_gather_invariant",
    "all_reduce",
    "group_size",
]


def _group(group):
    return parallel_state.get_tensor_model_parallel_group() \
        if group is None else group


def group_size(group=None) -> int:
    """Ranks in ``group`` (default: the tensor-parallel group; 1 on the
    one-process grid)."""
    if group is None:
        return parallel_state.get_tensor_model_parallel_world_size()
    return dist.get_world_size(group)


def _group_rank(group) -> int:
    if group is None:
        return parallel_state.get_tensor_model_parallel_rank()
    return dist.get_rank(group)


def all_reduce(x: torch.Tensor, op: str = "sum",
               group=None) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` with ``op`` ("sum",
    "max" or "min"); ``x`` itself over one rank."""
    if group_size(group) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX,
                             "min": dist.ReduceOp.MIN}[op],
                    group=_group(group))
    return out


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    world = group_size(group)
    if world == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=_group(group))
    return torch.cat(parts, dim=dim)


def _split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    world = group_size(group)
    if world == 1:
        return x
    if x.shape[dim] % world:
        raise ValueError(
            f"scatter_to_tensor_model_parallel_region: dim {dim} "
            f"({x.shape[dim]}) is not divisible by the group's size "
            f"({world})")
    return x.chunk(world, dim=dim)[_group_rank(group)].contiguous()


def all_gather_invariant(x: torch.Tensor, group=None, *, axis: int = 0,
                         tiled: bool = False) -> torch.Tensor:
    """The ranks' ``x`` joined along ``axis`` (``tiled``) or stacked on a
    new leading ``axis``; the same tensor on every rank.  Not
    differentiable: the regions are."""
    if not tiled:
        x = x.unsqueeze(axis)
    return _gather(x, axis, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, group=ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, g.dim() - 1, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        return _split(g, g.dim() - 1, ctx.group), None


def copy_to_tensor_model_parallel_region(x: torch.Tensor,
                                         group=None) -> torch.Tensor:
    """Identity forward; the backward all-reduces the gradient."""
    if group_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from_tensor_model_parallel_region(x: torch.Tensor,
                                             group=None) -> torch.Tensor:
    """All-reduce (sum) forward; identity backward."""
    if group_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def scatter_to_tensor_model_parallel_region(x: torch.Tensor,
                                            group=None) -> torch.Tensor:
    """This rank's chunk of the last dim; the backward all-gathers."""
    if group_size(group) == 1:
        return x
    return _ScatterTo.apply(x, group)


def gather_from_tensor_model_parallel_region(x: torch.Tensor,
                                             group=None) -> torch.Tensor:
    """The ranks' chunks joined along the last dim (the same tensor on
    every rank); the backward keeps this rank's chunk."""
    if group_size(group) == 1:
        return x
    return _GatherFrom.apply(x, group)
