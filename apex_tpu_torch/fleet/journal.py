"""Durable write-ahead request journal: the RequestLog that survives
the process.

Counterpart of ``apex_tpu/fleet/journal.py``, byte-compatible with it
(docs/resilience.md, "The serving journal on disk"): a journal written by
either package recovers in the other.  Every record is one JSONL line
carrying a ``crc`` (``zlib.crc32``) over its canonical payload (sorted
keys, no whitespace), appended through ONE ``os.write`` on an
``O_APPEND`` fd, so a torn tail or a flipped bit is detected, never
replayed.  Three kinds follow a request:

- ``admit``: uid, prompt, budget, seed, SLO class, relative deadline,
  flushed at submission (write-ahead);
- ``progress``: the harvested-token delta with its stream ``off``set,
  buffered and flushed once a fleet step in one append;
- ``done``: the last delta and the completion reason.

:func:`recover_journal` replays the lines: CRC-failed or torn lines are
skipped and counted, and a gap (a delta whose ``off`` disagrees with the
accumulated stream) freezes that uid at its last consistent prefix,
which is safe: the streams are deterministic, so a resume regenerates the
rest.  ``FleetRouter.resume_from_journal`` turns the recovery into
re-admissions; reuse one journal path across restarts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from apex_tpu_torch.serving.serve import Request

__all__ = ["RequestJournal", "JournalRecovery", "recover_journal"]

#: uid types a journal can round-trip through JSON as dict keys
_UID_TYPES = (str, int)


def _canon(payload: Dict[str, Any]) -> bytes:
    """The canonical encoding the CRC covers: sorted keys, no
    whitespace — byte-stable across write and recovery."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _seal(payload: Dict[str, Any]) -> str:
    """One journal line: the payload plus its CRC."""
    rec = dict(payload)
    rec["crc"] = zlib.crc32(_canon(payload)) & 0xFFFFFFFF
    return json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n"


class RequestJournal:
    """Write-ahead JSONL journal for a fleet's request state.

    The router drives it: :meth:`admit` at submission (flushed before
    the submit returns), :meth:`sync` once per fleet step (buffers
    every entry's harvested-token delta and terminal state, then ONE
    batched ``os.write``).  ``stats`` self-times the write path:
    ``write_s`` against the fleet's serving wall time is the journal's
    share (JAX's gate holds it under 2%).  ``logger`` is kept as the JAX
    journal keeps it (``self.logger``); the journal writes no telemetry
    record of its own: the router's events cover its admissions and
    replays."""

    def __init__(self, path: str, logger: Optional[Any] = None):
        self.path = str(path)
        self.logger = logger
        self._fd: Optional[int] = None
        self._fd_lock = threading.Lock()
        self._buf: List[str] = []
        #: uid -> stream length already journaled
        self._state: Dict[Any, int] = {}
        self._done: set = set()
        self.stats = {"appends": 0, "records": 0, "bytes": 0,
                      "write_s": 0.0}

    # ------------------------------------------------------------ write
    def _append(self, data: str) -> None:
        """One atomic append: O_APPEND + a single write, so records
        are whole lines on disk no matter who else appends."""
        t0 = time.perf_counter()
        with self._fd_lock:
            if self._fd is None:
                self._fd = os.open(
                    self.path,
                    os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            payload = data.encode("utf-8")
            os.write(self._fd, payload)
        self.stats["appends"] += 1
        self.stats["bytes"] += len(payload)
        self.stats["write_s"] += time.perf_counter() - t0

    def flush(self) -> None:
        """Land every buffered record in one append."""
        if not self._buf:
            return
        lines, self._buf = self._buf, []
        self.stats["records"] += len(lines)
        self._append("".join(lines))

    def close(self) -> None:
        self.flush()
        with self._fd_lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    # ----------------------------------------------------------- records
    def admit(self, entry: Any) -> None:
        """Journal one admission write-ahead: the record is on disk
        before the request is served.  ``entry`` is the failover log's
        :class:`~apex_tpu_torch.fleet.failover.LogEntry`."""
        req = entry.request
        if not isinstance(req.uid, _UID_TYPES):
            raise ValueError(
                f"journaled uids must be str or int (JSON-stable), "
                f"got {type(req.uid).__name__}: {req.uid!r}")
        self._buf.append(_seal({
            "k": "admit",
            "uid": req.uid,
            "prompt": [int(t) for t in req.prompt],
            "budget": int(req.max_new_tokens),
            "seed": None if req.seed is None else int(req.seed),
            "slo": entry.slo,
            "t": float(entry.t_arrive),
            "deadline_s": (None if entry.deadline_rel is None
                           else float(entry.deadline_rel)),
        }))
        self._state[req.uid] = 0
        self.flush()

    def handoff(self, uid: Any, src: str, dst: str) -> None:
        """Journal a page-level ownership transfer write-ahead: the
        record lands BEFORE any pages move, so a crash mid-transfer
        recovers a request that is at worst back on the recompute path
        (its admit + progress records still replay the stream
        token-identically).  Recovery ignores the record itself —
        replica names do not survive a restart — it exists for the
        durability ordering and for post-mortem forensics."""
        self._buf.append(_seal({
            "k": "handoff", "uid": uid, "src": str(src),
            "dst": str(dst)}))
        self.flush()

    def sync(self, log: Any) -> None:
        """Fold the in-memory :class:`RequestLog` into the journal:
        one progress/terminal delta per entry that moved, ONE batched
        append for the whole step."""
        for e in log.entries():
            uid = e.request.uid
            n = self._state.get(uid)
            if n is None or uid in self._done:
                continue
            if e.done:
                delta = e.emitted[n:]
                self._buf.append(_seal({
                    "k": "done", "uid": uid, "off": n,
                    "toks": [int(t) for t in delta],
                    "reason": e.reason,
                }))
                self._done.add(uid)
                self._state[uid] = len(e.emitted)
            elif len(e.emitted) > n:
                delta = e.emitted[n:]
                self._buf.append(_seal({
                    "k": "progress", "uid": uid, "off": n,
                    "toks": [int(t) for t in delta],
                }))
                self._state[uid] = len(e.emitted)
        self.flush()

    def prime(self, log: Any) -> None:
        """Seed the journal's in-memory cursor from a log rebuilt by
        :func:`recover_journal` WITHOUT re-writing records (their
        admits and deltas are already on disk): subsequent
        :meth:`sync` calls journal only NEW tokens.  Call it after
        ``FleetRouter.resume_from_journal`` when the restarted process
        appends to the same journal path."""
        for e in log.entries():
            uid = e.request.uid
            self._state[uid] = len(e.emitted)
            if e.done:
                self._done.add(uid)


@dataclasses.dataclass
class JournalRecovery:
    """What :func:`recover_journal` rebuilt from disk.

    ``entries`` maps uid to a dict with the recovered ``request``
    (the ORIGINAL — prompt/budget/seed as admitted), ``slo``,
    ``deadline_s`` (relative, re-armed on resume), the committed
    ``emitted`` stream, and ``done``/``reason``.  ``corrupt`` counts
    CRC-failed or torn lines (skipped), ``gapped`` counts uids whose
    stream was frozen at the last consistent prefix because a delta
    record was lost — both recover token-identically, the latter by
    regeneration."""

    entries: Dict[Any, Dict[str, Any]]
    records: int = 0
    corrupt: int = 0
    gapped: int = 0

    @property
    def inflight(self) -> Dict[Any, Dict[str, Any]]:
        return {u: i for u, i in self.entries.items() if not i["done"]}

    @property
    def completed(self) -> Dict[Any, Dict[str, Any]]:
        return {u: i for u, i in self.entries.items() if i["done"]}


def recover_journal(path: str) -> JournalRecovery:
    """Replay a journal file into per-uid recovered state.

    Tolerant by design: unparseable or CRC-failed lines (torn tail,
    bit flip) are skipped and counted; a uid whose next delta's
    ``off`` disagrees with its accumulated stream is marked gapped and
    frozen at the consistent prefix (later records for it are
    ignored — stitching across a hole would corrupt the stream, while
    regenerating from the prefix is exact).  A missing file recovers
    to an empty journal."""
    rec = JournalRecovery(entries={})
    gapped: set = set()
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return rec
    for line in raw.split(b"\n"):
        if not line.strip():
            continue
        try:
            obj = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            rec.corrupt += 1
            continue
        if not isinstance(obj, dict) or "crc" not in obj:
            rec.corrupt += 1
            continue
        crc = obj.pop("crc")
        if zlib.crc32(_canon(obj)) & 0xFFFFFFFF != crc:
            rec.corrupt += 1
            continue
        rec.records += 1
        kind = obj.get("k")
        uid = obj.get("uid")
        if kind == "admit":
            if uid in rec.entries:
                continue                    # duplicate admit: first wins
            rec.entries[uid] = {
                "request": Request(
                    uid=uid, prompt=list(obj["prompt"]),
                    max_new_tokens=int(obj["budget"]),
                    seed=obj.get("seed")),
                "slo": obj.get("slo"),
                "deadline_s": obj.get("deadline_s"),
                "t_arrive": obj.get("t"),
                "emitted": [],
                "done": False,
                "reason": None,
            }
        elif kind in ("progress", "done"):
            info = rec.entries.get(uid)
            if info is None or info["done"] or uid in gapped:
                continue
            if obj.get("off") != len(info["emitted"]):
                gapped.add(uid)
                rec.gapped += 1
                continue
            info["emitted"].extend(int(t) for t in obj["toks"])
            if kind == "done":
                info["done"] = True
                info["reason"] = obj.get("reason")
    return rec
