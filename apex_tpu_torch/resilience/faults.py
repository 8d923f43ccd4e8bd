"""Deterministic fault injection for the fleet's drills.

Counterpart of ``apex_tpu/resilience/faults.py``.  Every injection is count-based and deterministic (the
sleeps have deterministic placement), so a failing drill replays the
same way.

on-disk corruption, for the checkpoint's and the request journal's
drills:
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

checkpoint write faults (context managers patching the checkpoint
module's I/O seams ``checkpoint._open`` / ``checkpoint._replace``):
  :func:`failing_writes`   — fail the Nth (and following) write-opens
                             with a transient ``OSError``
  :func:`failing_renames`  — fail the atomic tmp→final rename
  :func:`sigterm_on_write` — deliver SIGTERM to this process at the
                             Nth write-open (a preemption notice landing
                             mid-save)

numeric faults:
  :func:`poison_tree` — NaN/Inf-poison one element of one floating leaf
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from typing import Any, Iterator, Optional

import torch

__all__ = [
    "truncate_file",
    "flip_bit",
    "remove_file",
    "failing_writes",
    "failing_renames",
    "sigterm_on_write",
    "poison_tree",
    "InjectedIOError",
    "stalled_pump",
    "hanging_harvests",
    "nonfinite_logits",
    "failing_windows",
    "exhaust_pool",
]


class InjectedIOError(OSError):
    """The transient storage failure raised by :func:`failing_writes`
    (an ``OSError`` subclass so production retry/except paths treat it
    exactly like the real thing, while tests can match the subtype)."""


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
def _is_write_mode(mode: str) -> bool:
    return any(c in mode for c in "wxa+")


class _SeamPatch:
    """Swap ``checkpoint._open`` for a counting interceptor."""

    def __init__(self, on_write):
        self._on_write = on_write
        self._lock = threading.Lock()
        self.write_count = 0

    def __enter__(self):
        from apex_tpu_torch import checkpoint as ckpt

        self._ckpt = ckpt
        self._orig_open = ckpt._open

        def intercepting_open(file, mode="r", *args, **kwargs):
            if _is_write_mode(mode):
                with self._lock:
                    self.write_count += 1
                    n = self.write_count
                self._on_write(n, file)
            return self._orig_open(file, mode, *args, **kwargs)

        ckpt._open = intercepting_open
        return self

    def __exit__(self, *exc):
        self._ckpt._open = self._orig_open
        return False


@contextlib.contextmanager
def failing_writes(fail_first: int = 1, path_substr: Optional[str] = None,
                   forever: bool = False) -> Iterator[_SeamPatch]:
    """Within the block, checkpoint write-opens raise
    :class:`InjectedIOError`: the first ``fail_first`` matching opens
    fail (then writes succeed — the retry-then-succeed scenario), or
    every matching open fails with ``forever=True`` (retry-exhausted).
    ``path_substr`` restricts injection to matching paths.

    The yielded handle exposes ``write_count`` (every checkpoint
    write-open seen, matching or not) and ``matched_writes`` (a
    single-element list with the count of ``path_substr``-matching
    write-opens, i.e. the injector's own counter)."""
    matched = [0]

    def on_write(n: int, file) -> None:
        if path_substr is not None and path_substr not in str(file):
            return
        matched[0] += 1
        if forever or matched[0] <= fail_first:
            raise InjectedIOError(
                f"injected transient I/O failure "
                f"(matching write #{matched[0]}) opening {file}"
            )

    with _SeamPatch(on_write) as patch:
        patch.matched_writes = matched
        yield patch


@contextlib.contextmanager
def failing_renames(fail_first: int = 1,
                    forever: bool = False) -> Iterator[list]:
    """Within the block, the checkpoint's atomic tmp→final rename
    (``checkpoint._replace``) raises :class:`InjectedIOError` for the
    first ``fail_first`` calls (or all of them with ``forever=True``).

    This targets the highest-stakes window in ``save()``: when the
    rename runs, the previous checkpoint at ``path`` is parked at
    ``path + ".old"`` — a failed rename must restore it (so even retry
    exhaustion leaves the old checkpoint in place), and a retried
    rename rebuilds the tmp dir and lands the new one.  Yields a
    single-element list holding the number of injected failures so
    far."""
    from apex_tpu_torch import checkpoint as ckpt

    orig = ckpt._replace
    count = [0]

    def flaky_replace(src, dst):
        if forever or count[0] < fail_first:
            count[0] += 1
            raise InjectedIOError(
                f"injected transient failure renaming {src} -> {dst} "
                f"(#{count[0]})"
            )
        return orig(src, dst)

    ckpt._replace = flaky_replace
    try:
        yield count
    finally:
        ckpt._replace = orig


@contextlib.contextmanager
def sigterm_on_write(nth: int = 1) -> Iterator[_SeamPatch]:
    """Deliver SIGTERM to this process at the ``nth`` checkpoint
    write-open — a preemption notice arriving exactly mid-save.  The
    write itself proceeds; what happens next is up to the installed
    handler (e.g. ``AutoResume._on_sigterm`` marks termination and the
    loop checkpoints at the next boundary)."""

    def on_write(n: int, file) -> None:
        if n == nth:
            os.kill(os.getpid(), signal.SIGTERM)

    with _SeamPatch(on_write) as patch:
        yield patch


# ---------------------------------------------------------------- numeric
def poison_tree(tree: Any, leaf_index: int = 0, element: int = 0,
                value: float = float("nan")) -> Any:
    """Return ``tree`` with one element of one floating leaf replaced by
    ``value`` (NaN by default, or e.g. ``float("inf")``): the scripted
    divergence event for :class:`~apex_tpu_torch.resilience.guard.
    StepGuard` tests.  Leaves are indexed in the checkpoint's flatten
    order (the JAX package's) over floating tensors only; the poisoned
    leaf is a copy, every other leaf passes through."""
    from apex_tpu_torch.checkpoint import flatten_tree, unflatten_tree

    flat, structure = flatten_tree(tree)
    float_positions = [
        i for i, leaf in enumerate(flat)
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
    ]
    if not float_positions:
        raise ValueError("poison_tree: tree has no floating leaves")
    if not 0 <= leaf_index < len(float_positions):
        raise ValueError(
            f"leaf_index {leaf_index} out of range "
            f"({len(float_positions)} floating leaves)"
        )
    pos = float_positions[leaf_index]
    leaf = flat[pos].detach().clone()
    leaf.reshape(-1)[element] = value
    flat = list(flat)
    flat[pos] = leaf
    return unflatten_tree(structure, flat)


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
