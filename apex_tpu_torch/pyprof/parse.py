"""Chrome trace -> per-op table (the reference's ``pyprof.parse`` stage).

Counterpart of ``apex_tpu/pyprof/parse.py``, which reads the xplane
protobuf the JAX profiler writes.  ``torch.profiler`` writes Chrome
traces instead: ``<dir>/**/trace.json`` as
:func:`apex_tpu_torch.pyprof.trace` and ``telemetry.spans.TraceTrigger``
export them, and ``<dir>/**/*.pt.trace.json`` as the TensorBoard handler
does.  Their complete events (``"ph": "X"``) aggregate into the same rows
as JAX's: device events (the categories ``kernel``, ``gpu_memcpy``,
``gpu_memset`` and ``gpu_user_annotation``) on plane ``GPU <n>`` and a
line per stream, host events on plane ``CPU`` and a line per thread;
annotation ranges (``user_annotation``, ``gpu_user_annotation``) on a
line of their own that :func:`apex_tpu_torch.pyprof.prof` drops as
envelopes.  Times are the trace's microseconds converted to ms.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch.pyprof.prof import ANNOTATION_LINE

__all__ = ["parse", "op_table", "trace_files", "DEVICE_CATEGORIES"]

#: the Chrome-trace categories of events that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset",
                     "gpu_user_annotation")
_ANNOTATIONS = ("user_annotation", "gpu_user_annotation")


def trace_files(log_dir: str) -> List[str]:
    """The Chrome traces under ``log_dir``, sorted."""
    paths = set()
    for pattern in ("trace.json", "*.pt.trace.json"):
        paths.update(glob.glob(os.path.join(log_dir, "**", pattern),
                               recursive=True))
    return sorted(paths)


def _place(ev: Dict[str, Any]) -> Tuple[str, str]:
    """(plane, line) of one event."""
    cat = str(ev.get("cat", ""))
    args = ev.get("args") or {}
    if cat in DEVICE_CATEGORIES:
        plane = f"GPU {args.get('device', ev.get('pid', 0))}"
        line = f"stream {args.get('stream', ev.get('tid', 0))}"
    else:
        plane, line = "CPU", f"thread {ev.get('tid', 0)}"
    if cat in _ANNOTATIONS:
        line = f"{line} {ANNOTATION_LINE}"
    return plane, line


def parse(
    log_dir: str,
    plane_filter: Optional[str] = None,
    line_filter: Optional[str] = None,
    exclude_prefixes: Tuple[str, ...] = ("end: ", "$"),
) -> List[Dict[str, Any]]:
    """Aggregate the traces captured under ``log_dir`` into per-op rows.

    Optional ``plane_filter`` / ``line_filter`` are case-insensitive
    substring matches (``plane_filter="GPU"``: the device's rows); by
    default every plane and line is read.  Events whose names start with
    one of ``exclude_prefixes`` are skipped.

    Returns rows sorted by total time, each::

        {"name", "count", "total_ms", "avg_ms", "pct", "plane", "line"}

    ``pct`` is relative to the summed duration of the included events.
    A directory without a trace raises ``FileNotFoundError``."""
    paths = trace_files(log_dir)
    if not paths:
        raise FileNotFoundError(
            f"no trace.json or *.pt.trace.json under {log_dir!r}: did the "
            "trace() context complete?")
    agg: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
    for path in paths:
        with open(path) as fh:
            doc = json.load(fh)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) \
            else doc
        for ev in events:
            if ev.get("ph") != "X":
                continue
            name = str(ev.get("name", ""))
            if any(name.startswith(p) for p in exclude_prefixes):
                continue
            plane, line = _place(ev)
            if plane_filter and plane_filter.lower() not in plane.lower():
                continue
            if line_filter and line_filter.lower() not in line.lower():
                continue
            row = agg.setdefault((plane, line, name), {
                "name": name, "plane": plane, "line": line, "count": 0,
                "total_ms": 0.0,
            })
            row["count"] += 1
            row["total_ms"] += float(ev.get("dur", 0.0)) / 1e3  # us -> ms
    rows = sorted(agg.values(), key=lambda r: -r["total_ms"])
    total = sum(r["total_ms"] for r in rows) or 1.0
    for r in rows:
        r["avg_ms"] = r["total_ms"] / max(r["count"], 1)
        r["pct"] = 100.0 * r["total_ms"] / total
    return rows


def op_table(rows: List[Dict[str, Any]], top: int = 25) -> str:
    """Format parse() rows the way the reference's ``prof`` stage prints
    its per-op table."""
    lines = [
        f"{'op':<48} {'count':>6} {'total ms':>10} {'avg ms':>9} {'%':>6}"
    ]
    for r in rows[:top]:
        lines.append(
            f"{r['name'][:48]:<48} {r['count']:>6} "
            f"{r['total_ms']:>10.3f} {r['avg_ms']:>9.3f} {r['pct']:>6.1f}"
        )
    return "\n".join(lines)
