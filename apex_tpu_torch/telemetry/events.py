"""Runtime event bus: where the checkpoint, resilience, serving and
fleet subsystems report what happened.

The port's own copy of ``apex_tpu/telemetry/events.py`` (stdlib only).
Every subsystem makes ONE cheap call, :func:`emit`, and the cost stays
honest:

- **no sink registered** (the default: a bare library import never grows
  I/O): ``emit`` is a truthiness check and a return, no dict is built,
  no timestamp is taken;
- **sink registered** (a :class:`~apex_tpu_torch.telemetry.metrics.
  MetricsLogger`, or any object with ``event(kind, **fields)``): the
  event fans out to every sink; a sink that raises is logged and dropped
  from that event, never allowed to break the training step that
  emitted it.

Emitters pass only plain host values (str/int/float/bool/None/lists of
those): events may be serialized to JSONL, and an event carrying a CUDA
tensor would force the host synchronisation the metrics layer exists to
avoid.

The module also holds :func:`ring_wire_bytes`, the per-device ring
bytes-on-wire model of a collective.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, Iterator, List, Optional

__all__ = ["add_sink", "remove_sink", "emit", "sink", "have_sinks",
           "ring_wire_bytes"]

logger = logging.getLogger("apex_tpu_torch.telemetry")

_SINKS: List[Any] = []


def add_sink(sink_obj: Any) -> None:
    """Register an event sink (anything with ``event(kind, **fields)``).
    Registering the same object twice is a no-op."""
    if not callable(getattr(sink_obj, "event", None)):
        raise TypeError(
            f"event sink needs an event(kind, **fields) method, got "
            f"{type(sink_obj).__name__}"
        )
    if sink_obj not in _SINKS:
        _SINKS.append(sink_obj)


def remove_sink(sink_obj: Any) -> None:
    """Deregister a sink; unknown sinks are ignored (shutdown paths may
    race double-removal)."""
    try:
        _SINKS.remove(sink_obj)
    except ValueError:
        pass


def have_sinks() -> bool:
    return bool(_SINKS)


def emit(kind: str, **fields: Any) -> None:
    """Report one event to every registered sink.

    Free when nothing listens; exceptions inside a sink are logged and
    swallowed — an observability failure must never take down the
    training loop it observes."""
    if not _SINKS:
        return
    for s in list(_SINKS):
        try:
            s.event(kind, **fields)
        except Exception:
            logger.exception("telemetry sink %r failed on event %r",
                             s, kind)


@contextlib.contextmanager
def sink(sink_obj: Any) -> Iterator[Any]:
    """Scoped registration::

        with events.sink(metrics_logger):
            train()   # subsystem events land in the logger
    """
    add_sink(sink_obj)
    try:
        yield sink_obj
    finally:
        remove_sink(sink_obj)


def ring_wire_bytes(op: str, group_size: int, operand_bytes: float,
                    result_bytes: Optional[float] = None) -> float:
    """Per-participating-device bytes on the wire for one collective
    under the ring-algorithm model:

    - ``all-reduce``:       ``2 * (g-1)/g * operand_bytes``
    - ``all-gather``:           ``(g-1)/g * result_bytes``
    - ``reduce-scatter`` / ``all-to-all``: ``(g-1)/g * operand_bytes``
    - ``collective-permute``:             ``operand_bytes``

    ``result_bytes`` defaults to ``operand_bytes`` for ops whose model
    reads the result side (all-gather callers usually know the gathered
    size; passing only the operand yields the pre-gather estimate).
    """
    g = max(int(group_size), 1)
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * operand_bytes
    if op == "all-gather":
        size = operand_bytes if result_bytes is None else result_bytes
        return (g - 1) / g * size
    if op in ("reduce-scatter", "all-to-all"):
        return (g - 1) / g * operand_bytes
    return float(operand_bytes)  # collective-permute
