"""Small shared helpers: the counterpart of ``apex_tpu/transformer/utils.py``.

``ensure_divisibility`` and ``divide`` are host arithmetic.  The 1-D
scatter and gather of the pipeline's activations split a tensor over the
tensor-parallel ranks; the port runs one rank, where this rank's chunk
is the whole flat tensor and the gather returns it as it is.  Over more
than one tensor-parallel rank (as
:func:`parallel_state.get_tensor_model_parallel_world_size` answers it;
a data-parallel world keeps one) they raise, naming ROADMAP.md queue A
item 9, which ports ``mappings.py`` and its collectives.
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


def _one_rank(what: str, axis_name: str) -> None:
    world = parallel_state.get_tensor_model_parallel_world_size()
    if world != 1:
        raise NotImplementedError(
            f"{what} over {world} ranks of axis {axis_name!r}: only one "
            "rank is ported (ROADMAP.md queue A item 9)")


def split_tensor_into_1d_equal_chunks(x: torch.Tensor,
                                      axis_name: str = "tp") -> torch.Tensor:
    """This rank's 1-D chunk of ``x`` flattened: at one rank, all of it."""
    _one_rank("split_tensor_into_1d_equal_chunks", axis_name)
    return x.reshape(-1)


def gather_split_1d_tensor(chunk: torch.Tensor,
                           axis_name: str = "tp") -> torch.Tensor:
    """The ranks' 1-D chunks joined into the flat tensor: at one rank,
    the chunk itself."""
    _one_rank("gather_split_1d_tensor", axis_name)
    return chunk.reshape(-1)
