"""Structured step metrics with deferred scalar resolution, and the
throughput arithmetic.

The port's counterpart of ``apex_tpu/telemetry/metrics.py``.  A trainer
that reads ``float(loss)`` every step puts a host synchronisation into
every step: the host waits for the stream to drain, so the next step's
launches cannot queue up behind the running one.
:class:`MetricsLogger` decouples recording from resolving:

- :meth:`~MetricsLogger.log_scalars` accepts tensors (0-d CUDA tensors in
  a training loop) and keeps them unresolved: an append to a host list,
  no copy, no synchronisation;
- every ``flush_every`` calls, :meth:`~MetricsLogger.flush` resolves
  everything pending in ONE device-to-host copy (through the module seam
  :data:`_device_get`), writes the JSONL records and prints the console
  line.

A divergence at step N is printed up to ``flush_every - 1`` steps late;
the values themselves are exact.  ``flush_every=1`` gives per-step
synchronous logging back.

Only rank 0 writes (``torch.distributed``'s rank when a process group is
initialised, else 0; ``process_zero_only=False`` to override).  JSONL
appends go through one ``O_APPEND`` ``write()`` a record, so concurrent
writers (a checkpoint thread emitting an event while the loop flushes)
interleave whole lines.  The record schema is the JAX package's
(``step``, ``throughput``, ``meters`` and ``event`` records, ``run`` and
``t``), so ``tools/metrics_report.py`` reads either.

:class:`StepStats` is the throughput aggregator: tokens/s and MFU from
:func:`transformer_flops_per_token` (the JAX numerator, ``6·N +
12·L·h·s``) over :func:`device_peak_flops` (the card's dense bf16 peak,
data sheet, SXM parts at their full power limit), with the first step
(which builds the kernels) excluded: :meth:`StepStats.begin` synchronises
on the first step's outputs and starts the clock after it.

:attr:`MetricsLogger.overhead_s` accumulates the host time spent inside
the logger's own calls, and :attr:`MetricsLogger.resolve_wait_s` the time
a flush waited for the device.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from apex_tpu_torch.telemetry import events as _events

__all__ = ["MetricsLogger", "StepStats", "transformer_flops_per_token",
           "device_peak_flops", "mfu"]

logger = logging.getLogger("apex_tpu_torch.telemetry")


def _resolve(values: List[torch.Tensor]) -> List[Any]:
    """Every tensor of ``values`` as host numbers, in one device-to-host
    copy: each is widened to float64 on its device (exact for every
    float32, bf16, fp16, int32 and bool value) and the flat pieces are
    joined there.  A 0-d tensor gives a float, any other a nested list."""
    flat = [v.detach().reshape(-1).to(torch.float64) for v in values]
    if len({f.device for f in flat}) > 1:
        flat = [f.cpu() for f in flat]
    host = torch.cat(flat).cpu() if flat else torch.zeros(0)
    out: List[Any] = []
    off = 0
    for v in values:
        n = v.numel()
        piece = host[off:off + n]
        out.append(piece.item() if v.dim() == 0
                   else piece.reshape(v.shape).tolist())
        off += n
    return out


# spy seam: tests count resolutions by replacing this module attribute;
# the logger routes EVERY device-to-host read through it
_device_get = _resolve


#: dense bf16 tensor-core peaks by device-name substring
PEAK_BF16_FLOPS = (
    ("H100", 989e12),
    ("H200", 989e12),
)


def transformer_flops_per_token(n_params: int, num_layers: int,
                                hidden_size: int, seq_len: int) -> int:
    """Model FLOPs per trained token: ``6·N`` (forward and backward
    matmuls) plus ``12·L·h·s`` (attention scores and context).  ``N`` is
    the model's parameter count as it stands: a SwiGLU model's gate
    (``fc_gate``, the third FFN matrix) is in it, and so is a learned
    position table, which a rope model does not have."""
    return 6 * n_params + 12 * num_layers * hidden_size * seq_len


def device_peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a CUDA device by name; None for the CPU
    or a card with no table entry (MFU is then omitted, not made up)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for key, peak in PEAK_BF16_FLOPS:
        if key in name:
            return peak
    return None


def mfu(tokens_per_s: float, flops_per_token: float,
        peak: Optional[float]) -> Optional[float]:
    """Model FLOPs utilisation, or None without a peak."""
    return None if not peak else tokens_per_s * flops_per_token / peak


def _is_device_value(v: Any) -> bool:
    return isinstance(v, torch.Tensor)


def _rank() -> int:
    """``torch.distributed``'s rank when a process group is initialised,
    else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _synchronize(outputs: Any) -> None:
    """Wait for the stream that computes ``outputs`` (a tensor or a
    tree of them): the port's ``jax.block_until_ready``.  CPU tensors
    are ready when they exist."""
    stack = [outputs]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


class StepStats:
    """Live throughput/MFU aggregation over a training loop.

    Usage (the port's trainers follow it)::

        stats = StepStats(tokens_per_step=global_batch * seq,
                          flops_per_token=flops_per_token)
        for i in range(start, steps):
            out = step(...)
            if i == start:
                stats.begin(out)   # blocks ONCE: compile excluded
            else:
                stats.tick()
        print(stats.summary(out))  # blocks on the last step

    ``begin(outputs)`` synchronises on the first step's outputs and
    starts the clock *after* — so the reported ms/step excludes the first
    step, which builds and loads the kernels.  ``tick()``
    counts a timed step (no sync).  ``summary(outputs)`` blocks on the
    final outputs and reports over the whole timed window;
    ``interval()`` reports over the window since the previous interval
    call — the per-flush live rate :class:`MetricsLogger` records.
    ``interval()`` itself never syncs: call it right after resolving
    the flushed scalars (as the logger does), when the wall clock
    honestly covers the executed steps.
    """

    def __init__(
        self,
        tokens_per_step: Optional[float] = None,
        flops_per_token: Optional[float] = None,
        peak_flops: Any = "auto",
        unit: str = "tokens",
        time_fn: Callable[[], float] = time.perf_counter,
    ):
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        # display label only ("tokens"/"seq"/"img"); the record key
        # stays tokens_per_sec so metrics_report reads one schema
        self.unit = unit
        self._peak = peak_flops
        self._time = time_fn
        self._t0: Optional[float] = None
        self._timed = 0
        self._mark_t: Optional[float] = None
        self._mark_timed = 0

    @property
    def peak_flops(self) -> Optional[float]:
        if self._peak == "auto":
            try:
                self._peak = device_peak_flops()
            except RuntimeError:  # no CUDA runtime to ask
                self._peak = None
        return self._peak

    @property
    def timed_steps(self) -> int:
        return self._timed

    def begin(self, outputs: Any = None) -> None:
        """Synchronise on ``outputs`` (the FIRST step's results), then
        start the clock: the one deliberate sync, paid so the first
        step's kernel builds never pollute ms/step."""
        if outputs is not None:
            _synchronize(outputs)
        self._t0 = self._mark_t = self._time()
        self._timed = self._mark_timed = 0

    def tick(self, n: int = 1) -> None:
        """Count ``n`` timed steps (no device interaction)."""
        self._timed += n

    def _rates(self, dt: float, steps: int) -> Dict[str, float]:
        out: Dict[str, float] = {
            "ms_per_step": dt / steps * 1e3,
            "steps_per_sec": steps / dt,
        }
        if self.tokens_per_step:
            tps = self.tokens_per_step * steps / dt
            out["tokens_per_sec"] = tps
            if self.flops_per_token and self.peak_flops:
                out["mfu"] = tps * self.flops_per_token / self.peak_flops
        return out

    def interval(self) -> Dict[str, float]:
        """Rates over the steps ticked since the last ``interval()``
        (empty before ``begin`` or when no step completed since)."""
        if self._t0 is None:
            return {}
        steps = self._timed - self._mark_timed
        now = self._time()
        # explicit None check: a perfectly-zero mark time (injected
        # clocks) must not read as "no mark"
        dt = now - (now if self._mark_t is None else self._mark_t)
        if steps <= 0 or dt <= 0:
            return {}
        self._mark_t, self._mark_timed = now, self._timed
        return self._rates(dt, steps)

    def summary(self, outputs: Any = None) -> Dict[str, float]:
        """Synchronise on ``outputs`` (the last step's results) and
        report over the whole timed window."""
        if outputs is not None:
            _synchronize(outputs)
        if self._t0 is None or self._timed <= 0:
            return {"timed_steps": 0}
        dt = self._time() - self._t0
        out = self._rates(dt, self._timed)
        out["timed_steps"] = self._timed
        out["wall_s"] = dt
        return out


class MetricsLogger:
    """Rank-aware structured metrics: counters, gauges, timings, step
    scalars and events, with deferred device-scalar resolution.

    Parameters
    ----------
    jsonl_path:
        Append JSONL records here (process 0 only).  None = console /
        meters only.
    console:
        Print one line per flush for the newest step (the trainer
        ``print`` replacement).
    flush_every:
        Flush cadence in :meth:`log_scalars` calls — the host-sync
        cadence.  1 reproduces per-step synchronous logging.
    stats:
        Optional :class:`StepStats`; its live :meth:`StepStats.interval`
        rates ride each flush as a ``throughput`` record.
    process_zero_only:
        Only rank 0 resolves and writes (other ranks drop records
        unresolved — no transfer, no file).
    run:
        Optional run id stamped on every record.

    Register the logger as an event sink
    (``apex_tpu_torch.telemetry.events.add_sink(logger)`` or
    ``attach_events()``) and subsystem events — checkpoint saves,
    divergence-guard escalations, GC, watchdog stalls, trace windows —
    land in the same JSONL stream as the step records.
    """

    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        console: bool = True,
        flush_every: int = 10,
        stats: Optional[StepStats] = None,
        process_zero_only: bool = True,
        run: Optional[str] = None,
        print_fn: Callable[[str], None] = print,
    ):
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.jsonl_path = jsonl_path
        self.console = console
        self.flush_every = flush_every
        self.stats = stats
        self.run = run
        self._print = print_fn
        self._pending: List[Tuple[float, int, Dict[str, Any]]] = []
        self._since_flush = 0
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._timings_ms: Dict[str, float] = {}
        self._meters_dirty = False
        self._last: Dict[str, float] = {}
        self._last_step: Optional[int] = None
        self._fd: Optional[int] = None
        # _write is reachable from other threads (an async checkpoint
        # save or the watchdog daemon emitting an event mid-flush); the
        # lock makes the lazy open and close/write races safe
        self._fd_lock = threading.Lock()
        #: host time spent inside the logger's own bookkeeping,
        #: serialization and file writes — the telemetry tax
        self.overhead_s = 0.0
        #: time ``flush`` spent BLOCKED in ``_device_get`` waiting for
        #: the flushed scalars to finish computing.  Tracked apart from
        #: ``overhead_s``: it is the amortized host sync the flush
        #: cadence exists to batch (a per-step ``float(loss)`` pays it
        #: every step), not work telemetry added
        self.resolve_wait_s = 0.0
        self.n_flushes = 0
        self.n_resolves = 0
        self.rank = _rank()
        self._active = (not process_zero_only) or self.rank == 0

    # ------------------------------------------------------------ record
    def log_scalars(self, step: int, **scalars: Any) -> None:
        """Record one step's scalars.  Device values stay unresolved
        (no transfer happens here); everything resolves together at the
        flush cadence."""
        t0 = time.perf_counter()
        self._pending.append((time.time(), int(step), dict(scalars)))
        self._since_flush += 1
        due = self._since_flush >= self.flush_every
        self.overhead_s += time.perf_counter() - t0
        if due:
            self.flush()

    def counter(self, name: str, inc: float = 1) -> None:
        """Monotonic counter (host values); cumulative totals ride each
        flush's ``meters`` record."""
        t0 = time.perf_counter()
        self._counters[name] = self._counters.get(name, 0) + inc
        self._meters_dirty = True
        self.overhead_s += time.perf_counter() - t0

    def gauge(self, name: str, value: Any) -> None:
        """Last-value-wins gauge; device values resolve at flush."""
        t0 = time.perf_counter()
        self._gauges[name] = value
        self._meters_dirty = True
        self.overhead_s += time.perf_counter() - t0

    class _Timing:
        def __init__(self, owner: "MetricsLogger", name: str):
            self._owner, self._name = owner, name

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt_ms = (time.perf_counter() - self._t0) * 1e3
            o = self._owner
            o._timings_ms[self._name] = (
                o._timings_ms.get(self._name, 0.0) + dt_ms
            )
            o._meters_dirty = True
            return False

    def timing(self, name: str) -> "MetricsLogger._Timing":
        """Context manager accumulating host wall-time per name (e.g.
        ``with tlm.timing("data"):`` around the batch fetch)."""
        return self._Timing(self, name)

    def event(self, kind: str, **fields: Any) -> None:
        """Record one host-side event — written immediately (events are
        rare and already resolved; buffering them behind the scalar
        cadence would reorder them against the failures they explain).
        This is also the sink interface :mod:`apex_tpu_torch.telemetry.events`
        fans out to."""
        t0 = time.perf_counter()
        if self._active:
            rec = {"t": time.time(), "kind": "event", "event": str(kind)}
            if self.run is not None:
                rec["run"] = self.run
            rec.update(fields)
            self._write(rec)
            logger.info("event %s %s", kind, fields)
        self.overhead_s += time.perf_counter() - t0

    # ------------------------------------------------------------- flush
    @property
    def last(self) -> Dict[str, float]:
        """Most recently *resolved* scalar values (after a flush) —
        lets the trainer return its final loss without an extra sync."""
        return dict(self._last)

    @property
    def last_step(self) -> Optional[int]:
        return self._last_step

    def flush(self) -> None:
        """Resolve every pending device scalar in one batched transfer
        and write/print the records.  This is the ONE place the logger
        blocks on the device."""
        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        self._since_flush = 0
        gauges = dict(self._gauges)
        meters_due = self._meters_dirty
        self._meters_dirty = False
        if not self._active:
            self.overhead_s += time.perf_counter() - t0
            return
        # batch-resolve: ONE _device_get over every unresolved value in
        # this window (scalars + device-valued gauges)
        handles: List[Any] = []
        slots: List[Tuple[Dict[str, Any], str]] = []
        for _, _, scalars in pending:
            for k, v in scalars.items():
                if _is_device_value(v):
                    handles.append(v)
                    slots.append((scalars, k))
        for k, v in gauges.items():
            if _is_device_value(v):
                handles.append(v)
                slots.append((gauges, k))
        resolve_dt = 0.0
        if handles:
            t_resolve = time.perf_counter()
            resolved = _device_get(handles)
            resolve_dt = time.perf_counter() - t_resolve
            self.resolve_wait_s += resolve_dt
            self.n_resolves += 1
            for (container, key), val in zip(slots, resolved):
                container[key] = val
        records: List[Dict[str, Any]] = []
        for t, step, scalars in pending:
            vals = {k: _as_host_number(v) for k, v in scalars.items()}
            rec = {"t": t, "kind": "step", "step": step}
            if self.run is not None:
                rec["run"] = self.run
            rec.update(vals)
            records.append(rec)
            self._last.update(vals)
            self._last_step = step
        rates: Dict[str, float] = {}
        if self.stats is not None and pending:
            # the _device_get above forced execution through the newest
            # flushed step, so the interval wall clock is honest
            rates = self.stats.interval()
            if rates:
                rec = {"t": time.time(), "kind": "throughput",
                       "step": self._last_step}
                if self.run is not None:
                    rec["run"] = self.run
                rec.update(rates)
                records.append(rec)
        if meters_due:
            rec = {"t": time.time(), "kind": "meters",
                   "step": self._last_step}
            if self.run is not None:
                rec["run"] = self.run
            if self._counters:
                rec["counters"] = dict(self._counters)
            if gauges:
                rec["gauges"] = {
                    k: _as_host_number(v) for k, v in gauges.items()
                }
            if self._timings_ms:
                rec["timings_ms"] = {
                    k: round(v, 3) for k, v in self._timings_ms.items()
                }
            records.append(rec)
        for rec in records:
            self._write(rec)
        if self.console and pending:
            parts = [f"{k} {_fmt(v)}" for k, v in self._last.items()]
            if rates:
                parts.append(f"{rates['ms_per_step']:.1f} ms/step")
                if "tokens_per_sec" in rates:
                    unit = getattr(self.stats, "unit", "tokens")
                    parts.append(
                        f"{rates['tokens_per_sec']:,.0f} {unit}/s")
                if "mfu" in rates:
                    parts.append(f"mfu {rates['mfu']:.3f}")
            self._print(f"step {self._last_step}: " + "  ".join(parts))
        self.n_flushes += 1
        # the device wait is accounted in resolve_wait_s, not here:
        # overhead_s is the tax telemetry ADDS, the wait is the per-step
        # sync batched to the cadence
        self.overhead_s += (time.perf_counter() - t0) - resolve_dt

    def close(self) -> None:
        """Flush everything pending, deregister from the event bus
        (a no-op if never attached), and close the JSONL file — so a
        trainer's exception path cannot leak a dead logger into the
        global sink list or hold the fd open."""
        if self._pending or self._meters_dirty:
            self.flush()
        _events.remove_sink(self)
        with self._fd_lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def attach_events(self) -> "MetricsLogger":
        """Register this logger on the global event bus (subsystem
        events — checkpoint, guard, watchdog — start landing here).
        Returns self; :meth:`close` deregisters it (or use
        ``events.sink(logger)`` for explicit scoping)."""
        _events.add_sink(self)
        return self

    # ------------------------------------------------------------- sink
    def _write(self, rec: Dict[str, Any]) -> None:
        if self.jsonl_path is None:
            return
        line = json.dumps(rec, default=_json_default) + "\n"
        try:
            with self._fd_lock:
                if self._fd is None:
                    d = os.path.dirname(self.jsonl_path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    # O_APPEND: each record lands as ONE write()
                    # syscall, so lines from concurrent writers (async
                    # checkpoint thread events vs the step loop)
                    # interleave whole, never torn
                    self._fd = os.open(
                        self.jsonl_path,
                        os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644,
                    )
                os.write(self._fd, line.encode())
        except OSError as e:
            logger.warning("metrics JSONL write failed: %s", e)


def _as_host_number(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return v  # non-numeric payloads pass through (e.g. strings)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def _json_default(v: Any):
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)
