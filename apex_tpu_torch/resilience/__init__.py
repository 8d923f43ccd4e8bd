"""apex_tpu_torch.resilience: the divergence guard and the fleet's faults.

Counterpart of ``apex_tpu/resilience``, of which the port has
:mod:`~apex_tpu_torch.resilience.guard` (:class:`StepGuard`) and the
serving and on-disk parts of :mod:`~apex_tpu_torch.resilience.faults`
(the fleet's drills); the checkpoint retry, the watchdog and the
checkpoint fault seams come with checkpointing, ROADMAP.md queue A item
10.
"""

from apex_tpu_torch.resilience.guard import (
    DivergenceError,
    GuardVerdict,
    StepGuard,
    locate_nonfinite,
)
from apex_tpu_torch.resilience import faults  # noqa: F401

__all__ = ["DivergenceError", "GuardVerdict", "StepGuard",
           "locate_nonfinite", "faults"]
