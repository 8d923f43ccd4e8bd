"""Auto-resume: periodic checkpoints and latest-state recovery.

The port's counterpart of ``apex_tpu/utils/autoresume.py``, built on
:mod:`apex_tpu_torch.checkpoint`:

- :class:`AutoResume` saves the full train state every
  ``interval_steps`` and on SIGTERM (preemption notice), keeps the last
  ``keep`` checkpoints, and resumes from the newest one at startup;
- state is any tree the checkpoint takes: parameters, optimizer state,
  amp state dicts, data-iterator counters.

Resume walks back from the newest checkpoint past corrupt / truncated /
incomplete directories (:func:`apex_tpu_torch.checkpoint.
restore_latest_valid`), so the process a preemption killed mid-write, or
a bit-flipped blob, costs one checkpoint interval, never the run.
"""

from __future__ import annotations

import logging
import os
import shutil
import signal
from typing import Any, Optional, Set, Tuple

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.telemetry import events as _events

__all__ = ["AutoResume"]

logger = logging.getLogger("apex_tpu_torch.autoresume")


class AutoResume:
    def __init__(
        self,
        root: str,
        interval_steps: int = 1000,
        keep: int = 2,
        install_sigterm_handler: bool = False,
    ):
        if keep < 1:
            # keep=0 would let _gc delete the checkpoint it just wrote
            raise ValueError(f"keep must be >= 1, got {keep}")
        if interval_steps < 1:
            raise ValueError(
                f"interval_steps must be >= 1, got {interval_steps}"
            )
        self.root = root
        self.interval_steps = interval_steps
        self.keep = keep
        self._termination_requested = False
        self._termination_save_done = False
        # steps known to hold a valid checkpoint: every step this
        # process saved or verified.  Lets _gc be validity-aware
        # without re-checksumming every kept checkpoint on every save.
        self._known_valid: Set[int] = set()
        self._prev_sigterm = None
        self._installed = bool(install_sigterm_handler)
        if install_sigterm_handler:
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, self._on_sigterm
            )

    # ------------------------------------------------------------ resume
    def resume(self, target: Optional[Any] = None) -> Tuple[Optional[Any], int]:
        """Returns (state, step) of the newest *valid* checkpoint, or
        (None, 0) when starting fresh.

        Corrupt or incomplete step directories (failed
        :func:`apex_tpu_torch.checkpoint.verify`, truncated blob, missing
        files) are logged and skipped — resume walks back until a
        checkpoint both verifies and loads."""
        state, step = ckpt.restore_latest_valid(self.root, target=target)
        if step is None:
            _events.emit("autoresume_fresh", root=self.root)
            return None, 0
        self._known_valid.add(step)
        _events.emit("autoresume_resume", root=self.root, step=step)
        return state, step

    # -------------------------------------------------------------- save
    def _step_is_valid(self, step: int, path: str, deep: bool) -> bool:
        """Whether a step dir may count toward ``keep``.  Raises
        ``OSError`` on a transient read failure (missing files still
        read as invalid) — the caller must not destroy a checkpoint it
        could not actually inspect."""
        if step in self._known_valid:
            return True
        bad = ckpt.verify(path, deep=deep, raise_transient=True)
        if bad:
            return False
        self._known_valid.add(step)
        return True

    def _gc(self, just_saved: Optional[int] = None) -> None:
        """Keep the ``keep`` newest *valid* checkpoints; remove the rest.

        Validity-aware so resuming past corrupt newer steps can never
        end with GC deleting the valid checkpoint it just wrote in
        favor of corrupt higher-numbered dirs: corrupt dirs don't count
        toward ``keep`` and are themselves removed (a visible step dir
        failing :func:`apex_tpu_torch.checkpoint.verify` is genuinely corrupt
        — in-flight writers are ``.tmp`` husks, which
        ``ckpt._steps_desc`` already excludes).  ``just_saved`` is kept
        unconditionally.

        Cost control: dirs NEWER than ``just_saved`` (the dangerous
        case — exactly what a fallback past corrupt steps leaves
        behind, and normally none exist) get the full checksum verify;
        older uncached dirs get the stat-level check (``deep=False``),
        so the save path never streams multi-GB blobs.  A transient
        read error during verification leaves the dir in place,
        uncounted — one storage blip must not delete a healthy
        checkpoint."""
        kept = 0
        for step in ckpt._steps_desc(self.root):
            path = os.path.join(self.root, f"step_{step}")
            if kept < self.keep:
                deep = just_saved is None or step > just_saved
                try:
                    valid = self._step_is_valid(step, path, deep)
                except OSError as e:
                    logger.warning(
                        "cannot verify checkpoint %s (%s); leaving it "
                        "in place unjudged", path, e,
                    )
                    continue  # retained, but does not count toward keep
                if valid:
                    kept += 1
                    continue
                logger.warning(
                    "autoresume GC removing corrupt checkpoint %s", path
                )
                _events.emit("autoresume_gc", step=step, corrupt=True)
            elif step == just_saved:  # invariant backstop: never delete it
                kept += 1
                continue
            else:
                _events.emit("autoresume_gc", step=step, corrupt=False)
            shutil.rmtree(path, ignore_errors=True)
            self._known_valid.discard(step)

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save when the interval elapses or termination was requested.
        Returns True if a checkpoint was written.

        A termination request triggers exactly ONE forced save (the
        flag is consumed once its checkpoint lands); subsequent steps
        fall back to the normal interval schedule instead of re-saving
        and GC-churning every step.  ``termination_requested()`` keeps
        reporting True so the loop still exits at its boundary."""
        termination_due = (
            self._termination_requested and not self._termination_save_done
        )
        due = force or termination_due or (
            step > 0 and step % self.interval_steps == 0
        )
        if not due:
            return False
        ckpt.save_step(self.root, step, state)
        self._known_valid.add(step)
        if termination_due:
            self._termination_save_done = True
        self._gc(just_saved=step)
        return True

    # ---------------------------------------------------------- discard
    def discard_step(self, step: int) -> None:
        """Quarantine one step directory (e.g. a checksum-valid snapshot
        of an already-diverged state that rollback must not resume
        into): renamed to ``step_<N>.discarded`` (``.discarded.<k>`` if
        that name is taken — a repeated divergence at the same step
        must not overwrite the earlier forensic copy), which resume/GC
        never see, rather than deleted — training history stays on disk
        for forensics even if every checkpoint turns out to be
        poisoned."""
        src = os.path.join(self.root, f"step_{step}")
        dst = src + ".discarded"
        k = 1
        while os.path.exists(dst):
            dst = src + f".discarded.{k}"
            k += 1
        try:
            os.rename(src, dst)
        except FileNotFoundError:
            pass
        self._known_valid.discard(step)

    def discard_steps_after(self, step: int) -> None:
        """Quarantine every step directory numbered above ``step``,
        making a rollback durable: a crash right after it resumes from
        ``step`` (or older), not from a stale newer checkpoint, and
        later saves at lower step numbers are never GC'd in favor of
        those dirs."""
        for s in ckpt._steps_desc(self.root):
            if s > step:
                logger.warning(
                    "discarding checkpoint step_%d (newer than rollback "
                    "point %d)", s, step,
                )
                self.discard_step(s)

    # --------------------------------------------------- failure signal
    def _on_sigterm(self, signum, frame):
        # mark only; the training loop saves at the next step boundary
        # (async-safe: no I/O in the handler)
        self._termination_requested = True
        self._termination_save_done = False
        prev = self._prev_sigterm
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            # chain: whoever installed a handler before us (cluster
            # agent, profiler flusher) still gets the notice
            prev(signum, frame)

    def close(self) -> None:
        """Put back the SIGTERM handler this object replaced (a no-op
        without one): after the loop, a SIGTERM must again do what it
        did before, not mark a termination nobody reads."""
        if self._installed:
            self._installed = False
            signal.signal(
                signal.SIGTERM,
                signal.SIG_DFL if self._prev_sigterm is None
                else self._prev_sigterm)

    def termination_requested(self) -> bool:
        """Whether a termination was requested (SIGTERM or
        :meth:`request_termination`): the loop exits at its boundary."""
        return self._termination_requested

    def request_termination(self) -> None:
        self._termination_requested = True
        self._termination_save_done = False
