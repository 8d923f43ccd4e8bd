"""apex_tpu_torch.resilience: the divergence guard around the loss scaler.

Counterpart of ``apex_tpu/resilience``, of which the port has
:mod:`~apex_tpu_torch.resilience.guard` (:class:`StepGuard`); the
checkpoint retry, the watchdog and the fault-injection harness come with
checkpointing, ROADMAP.md queue A item 10.
"""

from apex_tpu_torch.resilience.guard import (
    DivergenceError,
    GuardVerdict,
    StepGuard,
    locate_nonfinite,
)

__all__ = ["DivergenceError", "GuardVerdict", "StepGuard",
           "locate_nonfinite"]
