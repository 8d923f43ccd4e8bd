"""Small shared helpers: the counterpart of ``apex_tpu/transformer/utils.py``.

``ensure_divisibility`` and ``divide`` are host arithmetic.  The 1-D
scatter and gather of the pipeline's activations split a tensor over the
tensor-parallel ranks of :mod:`parallel_state`: the scatter keeps this
rank's contiguous chunk of the flat tensor, the gather all-gathers the
chunks back into the flat tensor on every rank (through
``tensor_parallel.mappings``).  At one tensor-parallel rank (a
data-parallel world keeps one) the chunk is the whole flat tensor and
nothing is communicated.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer import parallel_state

__all__ = [
    "ensure_divisibility",
    "divide",
    "split_tensor_into_1d_equal_chunks",
    "gather_split_1d_tensor",
]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    """Raise ``ValueError`` unless ``denominator`` divides ``numerator``."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """``numerator // denominator``, which must divide exactly."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_into_1d_equal_chunks(x: torch.Tensor,
                                      axis_name: str = "tp") -> torch.Tensor:
    """This rank's 1-D chunk of ``x`` flattened (``axis_name`` must be the
    tensor-parallel axis, as in every caller of the JAX helper)."""
    _check_axis(axis_name)
    flat = x.reshape(-1)
    world = parallel_state.get_tensor_model_parallel_world_size()
    chunk = divide(flat.shape[0], world)
    rank = parallel_state.get_tensor_model_parallel_rank()
    return flat[rank * chunk:(rank + 1) * chunk]


def gather_split_1d_tensor(chunk: torch.Tensor,
                           axis_name: str = "tp") -> torch.Tensor:
    """The ranks' 1-D chunks joined into the flat tensor, the same on
    every rank."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        all_gather_invariant,
    )

    _check_axis(axis_name)
    return all_gather_invariant(chunk.reshape(-1), axis=0, tiled=True)


def _check_axis(axis_name: str) -> None:
    if axis_name != parallel_state.TENSOR_PARALLEL_AXIS:
        raise ValueError(
            f"axis_name {axis_name!r}: the 1-D split and gather run over "
            "the tensor-parallel group")
