"""Phase-segmented traces: named phase ranges and an on-demand trigger.

The port's counterpart of ``apex_tpu/telemetry/spans.py``.  Two halves:

**Phase ranges**: :func:`phase` wraps a region in
``torch.profiler.record_function`` under the common ``tlm.<name>``
prefix, so a profiler trace groups the step by phase (:data:`PHASES`:
``data``, ``fwd_bwd``, ``optimizer``, ``checkpoint``, ``prefill``,
``decode``, ...).  Outside a profiler a range costs one small host
object.

**On-demand trace trigger**: :class:`TraceTrigger` answers "the run is
live and slow *now*; get me a trace without restarting".  The loop calls
:meth:`TraceTrigger.poll` once per step (a host-side ``os.path`` check,
amortized by ``poll_every``); arming it, by touching a file or by
exporting ``APEX_TPU_TRACE_DIR`` before launch, captures a
``torch.profiler`` window of the next K steps, then disarms.
Re-touching the file captures another window; each lands in its own
``step<N>`` directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
from typing import Iterator, Optional

import torch

from apex_tpu_torch.telemetry import events as _events

__all__ = ["PHASES", "PHASE_PREFIX", "phase", "TraceTrigger", "TRACE_FILE"]

logger = logging.getLogger("apex_tpu_torch.telemetry")

#: The step-anatomy phases the trainers and the batcher annotate (the
#: JAX package's list).
PHASES = ("data", "param_gather", "fwd_bwd", "grad_sync", "optimizer",
          "checkpoint", "prefill", "decode")

#: Every range shares this prefix, so a trace viewer's filter of "tlm."
#: shows exactly the phase segmentation.
PHASE_PREFIX = "tlm."

#: the Chrome trace each capture writes into its ``step<N>`` directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate a region as one step phase (``tlm.<name>``)."""
    with torch.profiler.record_function(PHASE_PREFIX + name):
        yield


class TraceTrigger:
    """Capture a ``torch.profiler`` window of K steps mid-run, on demand.

    Parameters
    ----------
    trace_dir:
        Where captures land (each in a ``step<N>`` subdirectory).
        Defaults to ``$APEX_TPU_TRACE_DIR`` when set — which ALSO arms
        the trigger once at startup, so exporting the variable before
        launch captures the run's first K steps with no code change.
    steps:
        Steps per capture window (``$APEX_TPU_TRACE_STEPS`` overrides).
    trigger_file:
        Touch this path mid-run to arm a capture; the trigger consumes
        (deletes) it on arming, so touching it again captures another
        window.  Defaults to ``$APEX_TPU_TRACE_TOUCH`` when set, else
        ``<trace_dir>/TRACE_REQUEST`` once a trace_dir is known.  If
        the touched file's first line names a directory, the capture
        goes there instead (steer one capture without re-launching).
    poll_every:
        Check the touch-file every N ``poll`` calls (the only per-step
        cost is this modulo when idle).

    Wire it into a loop::

        trig = TraceTrigger(trace_dir="/tmp/run_traces")
        for i in range(steps):
            out = step(...)
            trig.poll(i)

    ``poll`` starts the profiler *between* steps, so a window covers
    whole steps; :meth:`close` stops a capture the loop's end would
    otherwise truncate.  The window records the CPU and, where a card is
    present, the CUDA activity, with a ``torch.cuda.synchronize()`` at
    each edge (only while capturing), and lands as a Chrome trace
    ``trace.json`` in its ``step<N>`` directory.  A profiler that cannot
    start or stop raises: the capture was asked for.
    """

    def __init__(
        self,
        trace_dir: Optional[str] = None,
        steps: Optional[int] = None,
        trigger_file: Optional[str] = None,
        poll_every: int = 1,
    ):
        if poll_every < 1:
            raise ValueError(f"poll_every must be >= 1, got {poll_every}")
        env_dir = os.environ.get("APEX_TPU_TRACE_DIR")
        self.trace_dir = trace_dir or env_dir
        self.steps = int(
            steps if steps is not None
            else os.environ.get("APEX_TPU_TRACE_STEPS", "4")
        )
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        self.trigger_file = trigger_file or os.environ.get(
            "APEX_TPU_TRACE_TOUCH"
        ) or (os.path.join(self.trace_dir, "TRACE_REQUEST")
              if self.trace_dir else None)
        if self.trigger_file:
            # the arming mechanism must exist to be touchable: create
            # the directory the touch-file lives in (best-effort — a
            # read-only location just disables mid-run arming)
            d = os.path.dirname(self.trigger_file)
            if d:
                try:
                    os.makedirs(d, exist_ok=True)
                except OSError as e:
                    logger.warning(
                        "trace trigger dir %s not creatable (%s); "
                        "touch-file arming disabled", d, e)
                    self.trigger_file = None
        self.poll_every = poll_every
        self._polls = 0
        self._armed_by_env = env_dir is not None
        self._capturing_dir: Optional[str] = None
        self._prof: Optional[torch.profiler.profile] = None
        self._remaining = 0
        self.captures = 0

    # ------------------------------------------------------------ helpers
    def _consume_touch(self) -> Optional[str]:
        """If the touch-file exists: read an optional dir override from
        it, delete it (re-touch = re-arm), return the target dir."""
        tf = self.trigger_file
        if not tf or not os.path.exists(tf):
            return None
        target = None
        try:
            with open(tf) as f:
                first = f.readline().strip()
            if first:
                target = first
        except OSError:
            pass
        try:
            os.remove(tf)
        except OSError as e:
            # cannot consume it -> would re-trigger every window; warn
            # and fall through (the capture itself still proceeds)
            logger.warning("could not consume trace trigger %s: %s", tf, e)
        return target or self.trace_dir or os.path.join(
            tempfile.gettempdir(), "apex_tpu_trace")

    def _start(self, target: str, step: int) -> None:
        out = os.path.join(target, f"step{step}")
        os.makedirs(out, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self._prof = prof
        self._capturing_dir = out
        self._remaining = self.steps
        logger.info("trace trigger: capturing %d steps to %s",
                    self.steps, out)
        _events.emit("trace_start", dir=out, step=step,
                     window=self.steps)

    def _stop(self, step: int) -> None:
        out, self._capturing_dir = self._capturing_dir, None
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(out, TRACE_FILE))
        self.captures += 1
        logger.info("trace trigger: captured %s", out)
        _events.emit("trace_captured", dir=out, step=step,
                     window=self.steps)

    # -------------------------------------------------------------- poll
    @property
    def capturing(self) -> bool:
        return self._capturing_dir is not None

    def poll(self, step: int) -> bool:
        """Advance the trigger one step; returns True while a capture
        window is open.  Call once per training step, after the step's
        dispatch."""
        if self._capturing_dir is not None:
            self._remaining -= 1
            if self._remaining <= 0:
                self._stop(step)
            return self._capturing_dir is not None
        self._polls += 1
        armed_dir: Optional[str] = None
        if self._armed_by_env:
            # env arming is one-shot: the variable cannot change
            # mid-run, so it means "capture the first window"
            self._armed_by_env = False
            armed_dir = self.trace_dir
        elif self._polls % self.poll_every == 0:
            armed_dir = self._consume_touch()
        if armed_dir:
            self._start(armed_dir, step)
        return self._capturing_dir is not None

    def close(self) -> None:
        """Stop an in-flight capture (call when the loop ends)."""
        if self._capturing_dir is not None:
            self._stop(step=-1)
