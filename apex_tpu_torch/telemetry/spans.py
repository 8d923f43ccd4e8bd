"""Named phase scopes over ``torch.profiler.record_function``.

The port's counterpart of ``apex_tpu/telemetry/spans.py``'s ``phase``,
the only piece the serving path uses so far: a ``tlm.<name>`` range that
shows up in a ``torch.profiler`` trace around the prefill and decode
dispatches.  Outside a profiler it costs one small host object.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__all__ = ["phase", "PHASE_PREFIX"]

PHASE_PREFIX = "tlm."


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate a region as one step phase (``tlm.<name>``)."""
    with torch.profiler.record_function(PHASE_PREFIX + name):
        yield
