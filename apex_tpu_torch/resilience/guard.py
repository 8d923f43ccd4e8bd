"""StepGuard: divergence monitoring and escalation around the scaler.

Counterpart of ``apex_tpu/resilience/guard.py``.  The skip-step silently
skips an overflowed step and backs the loss scale off; that is right for
an isolated overflow and wrong for divergence, where every step is
skipped at ``min_loss_scale``.  :class:`StepGuard` watches the finite
flag the step already computes and escalates on consecutive non-finite
steps: a warning (naming the first non-finite gradients, if given), then
:class:`DivergenceError`.  The rollback to the last good checkpoint
(``autoresume=``) comes with checkpointing, ROADMAP.md queue A item 10,
and raises ``NotImplementedError`` until then; so do the JAX guard's
telemetry events, which wait for that item's ``telemetry.events``.

:meth:`StepGuard.observe` reads the flag on the host: one synchronisation
a call, outside the optimizer step, where the caller chooses to pay it.
"""

from __future__ import annotations

import logging
from typing import Any, List, NamedTuple, Optional

import torch

__all__ = ["StepGuard", "GuardVerdict", "DivergenceError",
           "locate_nonfinite"]

logger = logging.getLogger("apex_tpu_torch.resilience")


class DivergenceError(RuntimeError):
    """Training produced non-finite gradients for ``raise_after``
    consecutive steps."""


class GuardVerdict(NamedTuple):
    """:meth:`StepGuard.observe`'s result for one step: ``action`` "ok",
    "warn" (or "rollback", which the port does not take yet), the run of
    non-finite steps, and whether the loss scale sits at its floor."""

    action: str
    consecutive_bad: int
    at_scale_floor: bool = False
    restored_state: Optional[Any] = None
    restored_step: Optional[int] = None


def _named(tree: Any, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}[{i}]")


def locate_nonfinite(tree: Any, max_leaves: int = 8) -> List[str]:
    """Name the non-finite tensors of a tree (dicts, lists, tuples of
    tensors): ``name (kind xN/M)`` for up to ``max_leaves`` of them, in
    order.  Reads the tensors on the host: for diagnosing a bad step."""
    out: List[str] = []
    for name, t in _named(tree):
        if t is None or not t.is_floating_point():
            continue
        t = t.detach().float()
        n_nan = int(torch.isnan(t).sum())
        n_inf = int(torch.isinf(t).sum())
        if not n_nan + n_inf:
            continue
        kinds = "+".join(k for k, n in (("nan", n_nan), ("inf", n_inf)) if n)
        out.append(f"{name or '<root>'} ({kinds} x{n_nan + n_inf}/"
                   f"{t.numel()})")
        if len(out) >= max_leaves:
            break
    return out


class StepGuard:
    """Escalating monitor over the train loop's finite flag.

    ``scaler``: a :class:`~apex_tpu_torch.amp.scaler.LossScaler` (or
    anything with ``min_loss_scale``), for the scale-at-floor alarm.
    ``warn_after`` / ``rollback_after`` / ``raise_after``: thresholds of
    consecutive non-finite steps, ``1 <= warn <= rollback <= raise``;
    without ``autoresume`` no rollback is taken.  A finite step resets the
    run.
    """

    def __init__(self, scaler: Optional[Any] = None,
                 autoresume: Optional[Any] = None, warn_after: int = 3,
                 rollback_after: int = 6, raise_after: int = 10,
                 target: Optional[Any] = None):
        if not (1 <= warn_after <= rollback_after <= raise_after):
            raise ValueError(
                "need 1 <= warn_after <= rollback_after <= raise_after, "
                f"got {warn_after}/{rollback_after}/{raise_after}")
        if autoresume is not None:
            raise NotImplementedError(
                "StepGuard(autoresume=...): the rollback to a checkpoint is "
                "not ported yet (ROADMAP.md queue A item 10, "
                "checkpointing)")
        self.scaler = scaler
        self.autoresume = None
        self.warn_after = warn_after
        self.rollback_after = rollback_after
        self.raise_after = raise_after
        self.target = target
        self.consecutive_bad = 0
        self.total_bad = 0

    def _scale_at_floor(self, scaler_state: Optional[Any]) -> bool:
        floor = getattr(self.scaler, "min_loss_scale", None)
        if floor is None or scaler_state is None:
            return False
        return float(scaler_state.loss_scale) <= float(floor)

    def observe(self, finite: Any, step: Optional[int] = None,
                scaler_state: Optional[Any] = None,
                grads: Optional[Any] = None) -> GuardVerdict:
        """Record one step's finite flag (a bool or a 0-d tensor, read on
        the host) and escalate if needed.  ``grads`` is read only on a bad
        step at or past ``warn_after``, to name the non-finite ones."""
        if bool(finite):
            self.consecutive_bad = 0
            return GuardVerdict("ok", 0)
        self.consecutive_bad += 1
        self.total_bad += 1
        at_floor = self._scale_at_floor(scaler_state)
        where = f" at step {step}" if step is not None else ""
        if self.consecutive_bad >= self.raise_after:
            detail = self._diagnose(grads)
            raise DivergenceError(
                f"{self.consecutive_bad} consecutive nonfinite steps{where}"
                + (" with loss scale pinned at its floor" if at_floor
                   else "")
                + (f"; first nonfinite leaves: {detail}" if detail else ""))
        if self.consecutive_bad >= self.warn_after or at_floor:
            detail = self._diagnose(grads)
            logger.warning(
                "divergence guard%s: %d consecutive nonfinite steps%s%s",
                where, self.consecutive_bad,
                " (loss scale pinned at min_loss_scale)" if at_floor else "",
                f"; nonfinite leaves: {detail}" if detail else "")
            return GuardVerdict("warn", self.consecutive_bad, at_floor)
        return GuardVerdict("ok", self.consecutive_bad, at_floor)

    def _diagnose(self, grads: Optional[Any]) -> str:
        if grads is None:
            return ""
        return "; ".join(locate_nonfinite(grads))

    def reset(self) -> None:
        """Forget all history."""
        self.consecutive_bad = 0
        self.total_bad = 0
