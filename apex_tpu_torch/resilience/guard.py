"""StepGuard: divergence monitoring and escalation around the scaler.

Counterpart of ``apex_tpu/resilience/guard.py``.  The skip-step silently
skips an overflowed step and backs the loss scale off; that is right for
an isolated overflow and wrong for divergence, where every step is
skipped at ``min_loss_scale``.  :class:`StepGuard` watches the finite
flag the step already computes and escalates on consecutive non-finite
steps: a warning (naming the first non-finite gradients, if given), a
rollback to the last good checkpoint (``autoresume=``, an
:class:`~apex_tpu_torch.utils.autoresume.AutoResume`), then
:class:`DivergenceError`.  Each escalation emits the JAX guard's
telemetry event (``guard_warn``, ``guard_rollback``, ``guard_diverged``).

:meth:`StepGuard.observe` reads the flag on the host: one synchronisation
a call, outside the optimizer step, where the caller chooses to pay it.
"""

from __future__ import annotations

import logging
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.telemetry import events as _events

__all__ = ["StepGuard", "GuardVerdict", "DivergenceError",
           "locate_nonfinite"]

logger = logging.getLogger("apex_tpu_torch.resilience")


class DivergenceError(RuntimeError):
    """Training produced non-finite gradients for ``raise_after``
    consecutive steps."""


class GuardVerdict(NamedTuple):
    """:meth:`StepGuard.observe`'s result for one step: ``action`` "ok",
    "warn" or "rollback", the run of non-finite steps, and whether the
    loss scale sits at its floor; on "rollback", ``restored_state`` /
    ``restored_step`` carry what AutoResume recovered (the state may be
    None when no valid checkpoint existed)."""

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
    ``autoresume``: the rollback restores the newest checkpoint that is
    both checksum-valid and finite, once per divergence episode (without
    it no rollback is taken), passing ``target`` to ``resume``.  A finite
    step resets the run and re-arms the rollback.
    """

    def __init__(self, scaler: Optional[Any] = None,
                 autoresume: Optional[Any] = None, warn_after: int = 3,
                 rollback_after: int = 6, raise_after: int = 10,
                 target: Optional[Any] = None):
        if not (1 <= warn_after <= rollback_after <= raise_after):
            raise ValueError(
                "need 1 <= warn_after <= rollback_after <= raise_after, "
                f"got {warn_after}/{rollback_after}/{raise_after}")
        self.scaler = scaler
        self.autoresume = autoresume
        self.warn_after = warn_after
        self.rollback_after = rollback_after
        self.raise_after = raise_after
        self.target = target
        self.consecutive_bad = 0
        self.total_bad = 0
        self._rolled_back_this_episode = False

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
            self._rolled_back_this_episode = False
            return GuardVerdict("ok", 0)
        self.consecutive_bad += 1
        self.total_bad += 1
        at_floor = self._scale_at_floor(scaler_state)
        where = f" at step {step}" if step is not None else ""
        # rollback is considered BEFORE raise so that
        # rollback_after == raise_after still gives the configured
        # rollback one chance; the raise then fires on the next bad step
        if (self.consecutive_bad >= self.rollback_after
                and self.autoresume is not None
                and not self._rolled_back_this_episode):
            self._rolled_back_this_episode = True
            state, rstep = self._rollback()
            logger.error(
                "divergence guard%s: %d consecutive nonfinite steps — "
                "rolled back to checkpoint step %s",
                where, self.consecutive_bad, rstep)
            _events.emit(
                "guard_rollback", step=step,
                consecutive_bad=self.consecutive_bad,
                at_scale_floor=at_floor,
                restored_step=rstep, restored=state is not None)
            return GuardVerdict("rollback", self.consecutive_bad, at_floor,
                                state, rstep)
        if self.consecutive_bad >= self.raise_after:
            detail = self._diagnose(grads)
            _events.emit(
                "guard_diverged", step=step,
                consecutive_bad=self.consecutive_bad,
                at_scale_floor=at_floor, detail=detail)
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
            _events.emit(
                "guard_warn", step=step,
                consecutive_bad=self.consecutive_bad,
                at_scale_floor=at_floor, detail=detail)
            return GuardVerdict("warn", self.consecutive_bad, at_floor)
        return GuardVerdict("ok", self.consecutive_bad, at_floor)

    def _rollback(self) -> Tuple[Optional[Any], Optional[int]]:
        """Restore the newest checkpoint that is both checksum-valid AND
        finite, then make the rollback durable on disk.

        A divergence that outlived a save interval leaves checksum-valid
        snapshots of the already-NaN state on disk; resuming into one
        would make the rollback a no-op, so any restored state with
        nonfinite leaves is discarded and the walk continues.  Once a
        good state is found, step directories newer than it are
        quarantined (renamed to ``step_<N>.discarded``, invisible to
        resume but preserved for forensics) — otherwise a crash right
        after rollback resumes from the newest (diverged) checkpoint,
        and post-rollback saves at lower step numbers get GC'd in favor
        of those stale dirs.

        The discards go through ``AutoResume.discard_step`` /
        ``discard_steps_after`` when the autoresume object has them
        (duck-typed stand-ins without the methods just skip the disk
        cleanup)."""
        ar = self.autoresume
        discard_one = getattr(ar, "discard_step", None)
        discard_after = getattr(ar, "discard_steps_after", None)
        prev_rstep = None
        while True:
            state, rstep = ar.resume(target=self.target)
            if state is None:
                return None, rstep
            bad_leaves = locate_nonfinite(state, max_leaves=1)
            if not bad_leaves:
                if discard_after is not None:
                    try:
                        discard_after(rstep)
                    except OSError as e:
                        # good state is already in hand; a storage blip
                        # during cleanup must not crash the rollback
                        logger.error(
                            "could not discard checkpoints newer than "
                            "rollback point %s (%s); rollback is not "
                            "crash-durable", rstep, e,
                        )
                return state, rstep
            logger.warning(
                "checkpoint step %s is checksum-valid but already "
                "diverged (%s); discarding and walking back further",
                rstep, bad_leaves[0],
            )
            if discard_one is None or rstep == prev_rstep:
                # cannot remove it (no discard method, or the discard
                # silently failed and resume handed the same poisoned
                # step back): return it as-is rather than loop forever
                if rstep == prev_rstep:
                    logger.error(
                        "discard of diverged checkpoint step %s had no "
                        "effect; returning its state anyway", rstep,
                    )
                return state, rstep
            prev_rstep = rstep
            try:
                discard_one(rstep)
            except OSError as e:
                logger.error(
                    "could not discard diverged checkpoint step %s "
                    "(%s); returning its state anyway", rstep, e,
                )
                return state, rstep

    def _diagnose(self, grads: Optional[Any]) -> str:
        if grads is None:
            return ""
        return "; ".join(locate_nonfinite(grads))

    def reset(self) -> None:
        """Forget all history."""
        self.consecutive_bad = 0
        self.total_bad = 0
        self._rolled_back_this_episode = False
