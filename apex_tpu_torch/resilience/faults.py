"""Deterministic fault injection for the fleet's drills.

Counterpart of ``apex_tpu/resilience/faults.py``, the parts the serving
fleet needs.  Every injection is count-based and deterministic (the
sleeps have deterministic placement), so a failing drill replays the
same way.

on-disk corruption, for the request journal's drills:
  :func:`truncate_file`, :func:`flip_bit`, :func:`remove_file`

serving faults (context managers over a
:class:`~apex_tpu_torch.serving.serve.ContinuousBatcher` or its module
seam):
  :func:`stalled_pump`      — harvest windows sleep before running (the
                              wedged replica ``FleetPolicy.pump_timeout_s``
                              quarantines)
  :func:`hanging_harvests`  — the Nth harvest resolve (``serve._device_get``)
                              sleeps: a hung device-to-host sync
  :func:`nonfinite_logits`  — the Nth decode or verify step raises
                              ``FloatingPointError`` before dispatch
  :func:`failing_windows`   — the Nth harvest window raises (the
                              consecutive-fault quarantine's signal)
  :func:`exhaust_pool`      — steal the allocator's free pages (page
                              pressure, backpressure)

The checkpoint write seams (:func:`failing_writes`,
:func:`failing_renames`, :func:`sigterm_on_write`) need the checkpoint
module and raise ``NotImplementedError`` until it is ported (ROADMAP.md
queue A item 10).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

__all__ = [
    "truncate_file",
    "flip_bit",
    "remove_file",
    "failing_writes",
    "failing_renames",
    "sigterm_on_write",
    "stalled_pump",
    "hanging_harvests",
    "nonfinite_logits",
    "failing_windows",
    "exhaust_pool",
]


# --------------------------------------------------------------- on-disk
def truncate_file(path: str, keep_bytes: Optional[int] = None) -> int:
    """Truncate ``path`` (default: drop the second half), simulating a
    writer killed mid-stream or a short read off flaky storage.
    Returns the new size."""
    size = os.path.getsize(path)
    keep = size // 2 if keep_bytes is None else keep_bytes
    if keep >= size:
        raise ValueError(
            f"truncate_file would not shrink {path}: {keep} >= {size}"
        )
    os.truncate(path, keep)
    return keep


def flip_bit(path: str, byte_offset: int = 0, bit: int = 0) -> None:
    """XOR one bit of ``path`` in place — the minimal silent-corruption
    event a checksum must catch."""
    size = os.path.getsize(path)
    if not 0 <= byte_offset < size:
        raise ValueError(
            f"byte_offset {byte_offset} outside {path} ({size} bytes)"
        )
    with open(path, "r+b") as f:
        f.seek(byte_offset)
        b = f.read(1)[0]
        f.seek(byte_offset)
        f.write(bytes([b ^ (1 << bit)]))


def remove_file(path: str) -> None:
    """Delete one file (a lost object, a journal that never landed)."""
    os.remove(path)


# ----------------------------------------------------------- write seams
def _needs_checkpoint(name: str):
    raise NotImplementedError(
        f"faults.{name} patches the checkpoint module's write seams, which "
        "are not ported yet (ROADMAP.md queue A item 10)")


def failing_writes(*args, **kwargs):
    """Fail the Nth checkpoint write-open (needs the checkpoint module)."""
    _needs_checkpoint("failing_writes")


def failing_renames(*args, **kwargs):
    """Fail the checkpoint's atomic rename (needs the checkpoint
    module)."""
    _needs_checkpoint("failing_renames")


def sigterm_on_write(*args, **kwargs):
    """SIGTERM at the Nth checkpoint write-open (needs the checkpoint
    module)."""
    _needs_checkpoint("sigterm_on_write")


# ---------------------------------------------------------------- serving
@contextlib.contextmanager
def stalled_pump(batcher: Any, *, stall_s: float,
                 after_windows: int = 0,
                 forever: bool = True) -> Iterator[list]:
    """Within the block, ``batcher``'s harvest windows sleep ``stall_s``
    seconds before running — the wedged-replica signal (a hung collective,
    a runaway host callback) that ``FleetPolicy.pump_timeout_s``
    quarantines on.  The first ``after_windows`` windows run clean;
    with ``forever=False`` only one window stalls.  Yields a
    single-element list counting injected stalls.

    Patches ``_decode_window`` only — it is the single harvest entry
    point from ``pump()`` and itself dispatches to the speculative
    window, so one patch covers both paths without double-counting."""
    orig = batcher._decode_window
    seen = [0]
    stalls = [0]

    def slow_window(*a, **k):
        seen[0] += 1
        if seen[0] > after_windows and (forever or stalls[0] < 1):
            stalls[0] += 1
            time.sleep(stall_s)
        return orig(*a, **k)

    batcher._decode_window = slow_window
    try:
        yield stalls
    finally:
        batcher._decode_window = orig


@contextlib.contextmanager
def hanging_harvests(*, nth: int = 1, hang_s: float = 0.05,
                     forever: bool = False) -> Iterator[list]:
    """Within the block, the ``nth`` harvest resolve — the
    ``serve._device_get`` device→host sync every window ends on —
    sleeps ``hang_s`` seconds first (every resolve from the ``nth`` on
    with ``forever=True``): a hung device fetch.  Module-level seam, so
    it hits EVERY batcher — pair with ``FleetPolicy.pump_timeout_s`` to
    watch the slowest replica get quarantined.  Yields a single-element
    list counting resolves seen."""
    from apex_tpu_torch.serving import serve

    orig = serve._device_get
    count = [0]

    def hanging_get(x):
        count[0] += 1
        if count[0] == nth or (forever and count[0] >= nth):
            time.sleep(hang_s)
        return orig(x)

    serve._device_get = hanging_get
    try:
        yield count
    finally:
        serve._device_get = orig


@contextlib.contextmanager
def nonfinite_logits(batcher: Any, *, nth: int = 1,
                     forever: bool = False) -> Iterator[list]:
    """Within the block, ``batcher``'s ``nth`` decode/verify dispatch
    raises ``FloatingPointError`` BEFORE launching (every dispatch from
    the ``nth`` on with ``forever=True``) — the numerics blow-up a
    replica surfaces as a pump exception.  Raising before dispatch
    leaves carry and KV pools at the last harvested state, so the
    router's migration path re-serves every slot from consistent
    committed prefixes.  Yields a single-element list counting
    dispatches seen."""
    orig_decode = batcher.decode_fn
    orig_spec = batcher.spec_fn
    count = [0]

    def _gate():
        count[0] += 1
        if count[0] == nth or (forever and count[0] >= nth):
            raise FloatingPointError(
                f"injected nonfinite logits (resilience fault seam, "
                f"dispatch #{count[0]})")

    def poisoned_decode(*a, **k):
        _gate()
        return orig_decode(*a, **k)

    batcher.decode_fn = poisoned_decode
    if orig_spec is not None:
        def poisoned_spec(*a, **k):
            _gate()
            return orig_spec(*a, **k)
        batcher.spec_fn = poisoned_spec
    try:
        yield count
    finally:
        batcher.decode_fn = orig_decode
        batcher.spec_fn = orig_spec


@contextlib.contextmanager
def failing_windows(batcher: Any, *, nth: int = 1, count: int = 1,
                    error: type = RuntimeError) -> Iterator[list]:
    """Within the block, ``batcher``'s harvest windows ``nth`` through
    ``nth + count - 1`` raise ``error`` before running — the generic
    repeated-fault signal the router's consecutive-fault quarantine
    (``FleetPolicy.max_replica_faults``) counts.  One window = one
    ``pump()`` call's harvest, so ``count=1`` is a transient blip (the
    replica recovers, its consecutive counter resets) and
    ``count >= max_replica_faults`` forces quarantine.  Yields a
    single-element list counting windows seen.  (``_decode_window``
    patch only — the single harvest entry point, see
    :func:`stalled_pump`.)"""
    orig = batcher._decode_window

    seen = [0]

    def flaky_window(*a, **k):
        seen[0] += 1
        if nth <= seen[0] < nth + count:
            raise error(
                f"injected window failure (resilience fault seam, "
                f"window #{seen[0]})")
        return orig(*a, **k)

    batcher._decode_window = flaky_window
    try:
        yield seen
    finally:
        batcher._decode_window = orig


@contextlib.contextmanager
def exhaust_pool(cache: Any, *, leave_free: int = 0) -> Iterator[list]:
    """Within the block, steal all but ``leave_free`` of ``cache``'s
    free KV pages out-of-band (``cache`` is a ``PagedKVCache`` or
    anything exposing ``.allocator``) — admission sees a pool under
    memory pressure, which is what drives the router's page-pressure
    brownout rungs and ``too_large``/``queue_full`` backpressure.
    All-or-nothing like any allocation; pages are returned on exit.
    Yields the list of stolen page ids."""
    alloc = getattr(cache, "allocator", cache)
    n = max(0, alloc.num_free - int(leave_free))
    pages = alloc.alloc(n) if n else []
    try:
        yield pages
    finally:
        if pages:
            alloc.free(pages)
