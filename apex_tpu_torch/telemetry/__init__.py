"""apex_tpu_torch.telemetry: runtime metrics, events and phase traces.

The port's counterpart of ``apex_tpu/telemetry``, with the same three
modules:

- :mod:`~apex_tpu_torch.telemetry.metrics`: :class:`MetricsLogger`
  (counters, gauges, timings, step scalars; a rank-0 JSONL sink with
  atomic appends and a console line) whose tensor scalars stay
  unresolved until one batched device-to-host copy at the flush cadence,
  and :class:`StepStats` (live tokens/s and MFU);
- :mod:`~apex_tpu_torch.telemetry.events`: the subsystem event bus
  (checkpoint, guard, autoresume, watchdog, trace windows, the batcher
  and the fleet emit here; free when no sink listens);
- :mod:`~apex_tpu_torch.telemetry.spans`: ``tlm.<phase>`` ranges and
  :class:`TraceTrigger` (a touch-file or environment armed
  ``torch.profiler`` window of K steps).

``tools/metrics_report.py`` turns the JSONL stream into a run summary.
"""

from apex_tpu_torch.telemetry import events, metrics, spans  # noqa: F401
from apex_tpu_torch.telemetry.events import (
    add_sink,
    emit,
    remove_sink,
    ring_wire_bytes,
)
from apex_tpu_torch.telemetry.metrics import (
    MetricsLogger,
    StepStats,
    device_peak_flops,
    mfu,
    transformer_flops_per_token,
)
from apex_tpu_torch.telemetry.spans import (
    PHASE_PREFIX,
    PHASES,
    TraceTrigger,
    phase,
)

__all__ = ["MetricsLogger", "PHASES", "PHASE_PREFIX", "StepStats",
           "TraceTrigger", "add_sink", "device_peak_flops", "emit",
           "events", "metrics", "mfu", "phase", "remove_sink",
           "ring_wire_bytes", "spans", "transformer_flops_per_token"]
