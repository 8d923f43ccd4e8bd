"""Watchdog: stall detection for hung collectives, kernels and storage.

The port's counterpart of ``apex_tpu/resilience/watchdog.py``.  A job
that loses one participant does not crash; every other process blocks
forever inside a collective (or a synchronisation on a hung kernel),
holding its cards while producing nothing.  Hung storage reads do the
same to the input pipeline.  The only useful behaviours are (a) say
*where* everything is stuck, and (b) die loudly so the scheduler
requeues the job into :class:`~apex_tpu_torch.utils.autoresume.
AutoResume`.

:class:`Watchdog` is a daemon heartbeat thread: the training loop calls
:meth:`beat` once per step; if no beat arrives within ``deadline_s``
the watchdog dumps every thread's stack (stderr by default: the frame
waiting in a synchronisation pinpoints a hung step) and,
with ``abort=True``, hard-exits the process so the scheduler's
restart-policy takes over.  One dump per stall episode; a late beat
re-arms it.

Externally visible liveness: with a ``heartbeat_file`` (or
``$APEX_TPU_HEARTBEAT_FILE``) each :meth:`beat` also writes a tiny
JSON record — ``{"at": <unix>, "pid": ..., "step": ...}`` — atomically
(tmp + rename) and throttled to ~1 write/s, where out-of-process
observers read it (:func:`read_heartbeat`), so "the training job is
alive but stalled" and "the training job is gone" are distinguishable
from outside.  Stall detections additionally emit a
``watchdog_stall`` telemetry event.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Optional, TextIO

from apex_tpu_torch.telemetry import events as _events

__all__ = ["Watchdog", "read_heartbeat"]

logger = logging.getLogger("apex_tpu_torch.resilience")

#: Throttle for heartbeat-file writes: beats may come thousands/s in a
#: tight loop; liveness observers need ~1 Hz.
HEARTBEAT_WRITE_INTERVAL_S = 1.0


def read_heartbeat(path: Optional[str] = None) -> Optional[dict]:
    """Read a heartbeat file written by :meth:`Watchdog.beat`
    (``$APEX_TPU_HEARTBEAT_FILE`` when ``path`` is None); returns the
    record with an added ``age_s``, or None when absent/unreadable —
    the reader's contract is best-effort, never raising."""
    path = path or os.environ.get("APEX_TPU_HEARTBEAT_FILE")
    if not path:
        return None
    try:
        with open(path) as f:
            rec = json.load(f)
        if not isinstance(rec, dict) or "at" not in rec:
            return None
        rec["age_s"] = max(0.0, time.time() - float(rec["at"]))
        return rec
    except (OSError, ValueError, TypeError, KeyError):
        # TypeError covers a malformed "at" (null/list) — the contract
        # is best-effort, never raising
        return None


def dump_all_stacks(stream: Optional[TextIO] = None,
                    reason: str = "") -> str:
    """Format (and optionally write) a stack dump of every live thread.
    Returns the formatted text."""
    threads = {t.ident: t for t in threading.enumerate()}
    lines = [f"==== apex_tpu_torch watchdog stack dump{': ' if reason else ''}"
             f"{reason} ===="]
    for ident, frame in sys._current_frames().items():
        t = threads.get(ident)
        name = t.name if t is not None else "<unknown>"
        daemon = " daemon" if (t is not None and t.daemon) else ""
        lines.append(f"---- thread {name} (ident {ident}{daemon}) ----")
        lines.extend(
            l.rstrip("\n") for l in traceback.format_stack(frame)
        )
    text = "\n".join(lines) + "\n"
    if stream is not None:
        stream.write(text)
        stream.flush()
    return text


class Watchdog:
    """Heartbeat-deadline stall detector.

    Parameters
    ----------
    deadline_s:
        Seconds of heartbeat silence that count as a stall.
    poll_s:
        Check period (default ``deadline_s / 4``, floored at 10 ms).
    abort:
        After dumping stacks, kill the process with SIGABRT (core /
        nonzero exit → the scheduler requeues, AutoResume recovers).
    stream:
        Where stack dumps go (default ``sys.stderr``).
    on_stall:
        Optional callback ``on_stall(elapsed_s, dump_text)`` invoked on
        each stall detection, before any abort.  Exceptions in it are
        logged, never raised, and never cancel the abort.
    heartbeat_file:
        Where :meth:`beat` mirrors liveness for out-of-process readers
        (:func:`read_heartbeat`).  Defaults to
        ``$APEX_TPU_HEARTBEAT_FILE``; None/unset disables the mirror
        (the in-process stall detection is unaffected).

    Use as a context manager around the training loop, beating once per
    step::

        with Watchdog(deadline_s=600, abort=True) as wd:
            for step in range(n):
                loss = train_step(batch)
                wd.beat()

    The thread is a daemon and never blocks interpreter exit.
    """

    def __init__(
        self,
        deadline_s: float = 600.0,
        poll_s: Optional[float] = None,
        abort: bool = False,
        stream: Optional[TextIO] = None,
        on_stall: Optional[Callable[[float, str], None]] = None,
        heartbeat_file: Optional[str] = None,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if poll_s is not None and poll_s <= 0:
            # poll_s=0 would busy-spin the daemon thread at 100% CPU
            raise ValueError(f"poll_s must be > 0, got {poll_s}")
        self.deadline_s = deadline_s
        self.poll_s = max(0.01, deadline_s / 4.0) if poll_s is None \
            else poll_s
        self.abort = abort
        self.stream = stream
        self.on_stall = on_stall
        self.heartbeat_file = (
            heartbeat_file
            if heartbeat_file is not None
            else os.environ.get("APEX_TPU_HEARTBEAT_FILE")
        )
        self.stall_count = 0
        self._last_beat = time.monotonic()
        self._last_hb_write = 0.0
        self._stop = threading.Event()
        self._tripped = False  # one dump per stall episode
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "Watchdog":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("watchdog already running")
        self._stop.clear()
        self._last_beat = time.monotonic()
        self._tripped = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="apex-tpu-torch-watchdog"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, 2 * self.poll_s))
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ---------------------------------------------------------- heartbeat
    def beat(self, step: Optional[int] = None,
             extra: Optional[dict] = None) -> None:
        """Mark the loop alive (call once per step).  A loop that never
        synchronises beats while its launches queue up; a hung kernel
        then shows at the next synchronisation (a metrics flush, a
        checkpoint), which stops the beats.  With a heartbeat file
        configured, mirrors liveness there (throttled, atomic
        tmp+rename) so out-of-process observers see ``{"at", "pid",
        "step"}`` plus any ``extra`` fields: the serving fleet passes
        ``{"replica", "serving_step", "live_slots"}`` per pump so the
        stalled replica is NAMED, not just a stale timestamp."""
        self._last_beat = time.monotonic()
        self._tripped = False
        hb = self.heartbeat_file
        if hb is None:
            return
        now = time.time()
        if now - self._last_hb_write < HEARTBEAT_WRITE_INTERVAL_S:
            return
        self._last_hb_write = now
        rec = {"at": now, "pid": os.getpid()}
        if step is not None:
            rec["step"] = int(step)
        if extra:
            rec.update(extra)
        tmp = f"{hb}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, hb)
        except OSError as e:
            # liveness mirroring must never break the loop it observes
            logger.warning("heartbeat write to %s failed: %s", hb, e)

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            elapsed = time.monotonic() - self._last_beat
            if elapsed < self.deadline_s or self._tripped:
                continue
            self._tripped = True
            self.stall_count += 1
            text = dump_all_stacks(
                self.stream if self.stream is not None else sys.stderr,
                reason=f"no heartbeat for {elapsed:.1f}s "
                       f"(deadline {self.deadline_s:.1f}s)",
            )
            logger.error(
                "watchdog: step stalled for %.1fs (deadline %.1fs)",
                elapsed, self.deadline_s,
            )
            _events.emit(
                "watchdog_stall", elapsed_s=round(elapsed, 1),
                deadline_s=self.deadline_s, stall_count=self.stall_count,
                will_abort=self.abort,
            )
            if self.on_stall is not None:
                try:
                    self.on_stall(elapsed, text)
                except Exception:
                    logger.exception("watchdog on_stall callback failed")
            if self.abort:
                # SIGABRT, not sys.exit: raising in this daemon thread
                # would kill only the watchdog while the stall persists
                os.kill(os.getpid(), signal.SIGABRT)
