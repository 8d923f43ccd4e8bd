"""The model-parallel grad scaler: overflow consensus across tp/pp ranks.

Counterpart of ``apex_tpu/transformer/amp.py``, whose
:func:`model_parallel_all_finite` AND-reduces the finite flag over the
model-parallel mesh axes (a ``pmin`` of the int flag) so that every rank
skips the same steps.  Here it is an all-reduce MIN of the int flag over
the tensor-parallel group, and over the pipeline group when it has more
than one rank (``tensor_parallel.mappings.all_reduce``); an axis of one
rank issues nothing, so at world size 1 the consensus is the local flag
and no collective runs.
"""

from __future__ import annotations

from typing import Sequence

import torch

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import (
    PIPELINE_PARALLEL_AXIS,
    TENSOR_PARALLEL_AXIS,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_reduce,
    group_size,
)

__all__ = ["GradScaler", "model_parallel_all_finite"]


def model_parallel_all_finite(
        finite: torch.Tensor,
        axis_names: Sequence[str] = (TENSOR_PARALLEL_AXIS,
                                     PIPELINE_PARALLEL_AXIS)
) -> torch.Tensor:
    """The flag every rank of ``axis_names`` agrees on: True only where
    every rank's flag is (the reference's MAX all-reduce of found_inf,
    polarity flipped)."""
    groups = [g for g in map(parallel_state.get_axis_group, axis_names)
              if g is not None and group_size(g) > 1]
    if not groups:
        return finite
    out = finite.to(torch.int32)
    for group in groups:
        out = all_reduce(out, "min", group=group)
    return out.to(torch.bool)


class GradScaler(LossScaler):
    """A :class:`LossScaler` whose overflow check reaches model-parallel
    consensus (the local flag at world size 1)."""

    def __init__(self, *args, axis_names: Sequence[str] = (
            TENSOR_PARALLEL_AXIS, PIPELINE_PARALLEL_AXIS), **kwargs):
        super().__init__(*args, **kwargs)
        self.axis_names = tuple(axis_names)

    def unscale(self, state, grads):
        grads, finite = super().unscale(state, grads)
        return grads, model_parallel_all_finite(finite, self.axis_names)
