"""The model-parallel grad scaler at tensor- and pipeline-parallel world
size 1.

Counterpart of ``apex_tpu/transformer/amp.py``, whose
:func:`model_parallel_all_finite` AND-reduces the finite flag over the
model-parallel mesh axes so that every rank skips the same steps.  At
world size 1 the consensus is the local flag.  Over a process group it
needs the collectives of multi-GPU training, ROADMAP.md queue A item 9,
and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.transformer.parallel_state import (
    PIPELINE_PARALLEL_AXIS,
    TENSOR_PARALLEL_AXIS,
)

__all__ = ["GradScaler", "model_parallel_all_finite"]


def model_parallel_all_finite(
        finite: torch.Tensor,
        axis_names: Sequence[str] = (TENSOR_PARALLEL_AXIS,
                                     PIPELINE_PARALLEL_AXIS),
        group: Optional[Any] = None) -> torch.Tensor:
    """The flag every model-parallel rank agrees on: at world size 1 (no
    ``group``) the local flag itself."""
    if group is not None:
        raise NotImplementedError(
            "model_parallel_all_finite over a process group: the "
            "collectives of multi-GPU training are not ported yet "
            "(ROADMAP.md queue A item 9)")
    return finite


class GradScaler(LossScaler):
    """A :class:`LossScaler` whose overflow check reaches model-parallel
    consensus (the local flag at world size 1)."""

    def __init__(self, *args, axis_names: Sequence[str] = (
            TENSOR_PARALLEL_AXIS, PIPELINE_PARALLEL_AXIS),
            group: Optional[Any] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.axis_names = tuple(axis_names)
        self.group = group

    def unscale(self, state, grads):
        grads, finite = super().unscale(state, grads)
        return grads, model_parallel_all_finite(finite, self.axis_names,
                                                self.group)
