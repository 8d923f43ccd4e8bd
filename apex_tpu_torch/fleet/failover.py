"""Zero-loss replica failover: the replayable request log.

Counterpart of ``apex_tpu/fleet/failover.py`` (host Python, the same
code).  A replica is one
:class:`~apex_tpu_torch.serving.serve.ContinuousBatcher`, whose death
takes its device state, its unharvested window and its queue with it.
What must not die with it is the requests, and a request's whole
recoverable state is three host values the router already holds: the
original :class:`~apex_tpu_torch.serving.serve.Request` (prompt, budget,
seed), the tokens HARVESTED so far (harvest is the commit point), and
which replica holds it.

:class:`RequestLog` records exactly that, from
``ContinuousBatcher.progress()`` after every harvest.  On a replica's
death the router re-admits every in-flight entry elsewhere through
:func:`resume_request`: the committed tokens are replayed as a PROMPT
SUFFIX and the budget shrinks by their count.  The sampling keys fold the
slot key with the ABSOLUTE context length, so the replayed prefill lands
every token where it was and the continuation is the same stream (greedy,
or a request with a ``seed``).

Preconditions (the router enforces them at admission): a seeded request
or a greedy server, and ``len(prompt) + max_new_tokens - 1 <=
max_prompt_len`` so the replay prompt fits any replica's prefill window.

On the card the replayed suffix is written by the prefill, where the
unkilled run wrote it token by token through decode steps: in fp32 the
two agree to the bit, at bf16 they may round differently (the smoke
run's ``fleet`` phase holds the margin rule there).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from apex_tpu_torch.serving.serve import Request

__all__ = ["LogEntry", "RequestLog", "resume_request"]


@dataclasses.dataclass
class LogEntry:
    """One request's replayable state."""

    request: Request            # the ORIGINAL request, never mutated
    slo: str
    replica: str                # current holder
    t_arrive: float
    #: harvested tokens — committed prefix of the output stream
    emitted: List[int] = dataclasses.field(default_factory=list)
    #: tokens already moved into the prompt by past migrations; the
    #: current holder's own progress is appended on top of these
    replayed: List[int] = dataclasses.field(default_factory=list)
    replays: int = 0
    done: bool = False
    reason: Optional[str] = None
    #: first time any committed token was observed (harvest-boundary
    #: accurate) — the fleet-level, arrival-anchored TTFT numerator
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    #: absolute deadline (router clock) and the relative amount it was
    #: armed with — the router re-arms ``deadline_rel`` on a retry or
    #: a journal resume; None = no deadline (the default)
    deadline: Optional[float] = None
    deadline_rel: Optional[float] = None
    deadline_retries: int = 0
    #: ownership transfers that MOVED pages instead of replaying
    #: tokens (disaggregated prefill→decode handoffs) — unlike
    #: ``replays``, a handoff converts nothing to prompt suffix
    handoffs: int = 0


class RequestLog:
    """uid-keyed log of every admitted request's replayable state.

    The router drives it: :meth:`admit` at submission,
    :meth:`record_progress` after each replica harvest,
    :meth:`complete` when a completion surfaces, :meth:`reassign` when
    a migration moves an entry.  All host-side Python — the log's cost
    is a dict update per harvest."""

    def __init__(self):
        self._entries: Dict[Any, LogEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, uid: Any) -> bool:
        return uid in self._entries

    def get(self, uid: Any) -> LogEntry:
        return self._entries[uid]

    def admit(self, request: Request, slo: str, replica: str,
              t_arrive: float) -> LogEntry:
        if request.uid in self._entries:
            raise ValueError(
                f"uid {request.uid!r} is already logged — fleet uids "
                "must be unique across the run")
        e = LogEntry(request=request, slo=slo, replica=replica,
                     t_arrive=float(t_arrive))
        self._entries[request.uid] = e
        return e

    @staticmethod
    def _check_budget(e: "LogEntry") -> None:
        """The log's core invariant: a request never commits more than
        its budget.  The serving loop enforces it per step — one token
        per harvest record in the plain window, and the speculative
        window's device-side cap on multi-token commits
        (``n_commit <= steps_left``) — so a violation here means a
        broken batcher, and the resume math downstream
        (:func:`resume_request`) would turn it into a nonsensical
        negative budget.  Fail at the recording boundary instead, where
        the offending replica is still known."""
        if len(e.emitted) > e.request.max_new_tokens:
            raise ValueError(
                f"uid {e.request.uid!r} over-committed: "
                f"{len(e.emitted)} tokens recorded against a budget of "
                f"{e.request.max_new_tokens} on replica "
                f"{e.replica!r} — a multi-token (speculative) advance "
                "must be capped at the slot's remaining budget")

    def record_progress(self, replica: str,
                        progress: Dict[Any, List[int]],
                        now: float) -> None:
        """Fold one replica's post-harvest ``progress()`` into the log:
        ``emitted`` becomes the migration-committed tokens plus the
        current holder's harvested stream.  ``toks`` may grow by any
        number of tokens between calls — the speculative window
        commits up to k+1 per verify step — the log stores streams,
        not step counts, so multi-token advances need no special
        casing beyond the budget invariant check."""
        for uid, toks in progress.items():
            e = self._entries.get(uid)
            if e is None or e.done or e.replica != replica:
                continue
            e.emitted = e.replayed + list(toks)
            self._check_budget(e)
            if e.emitted and e.t_first is None:
                e.t_first = now

    def complete(self, uid: Any, tokens: List[int], reason: str,
                 now: float) -> LogEntry:
        e = self._entries[uid]
        e.emitted = e.replayed + list(tokens)
        self._check_budget(e)
        if e.emitted and e.t_first is None:
            e.t_first = now
        e.done, e.reason, e.t_done = True, reason, now
        return e

    def reassign(self, uid: Any, replica: str) -> None:
        """Move an entry to a new holder (a migration): the committed
        stream becomes replayed prompt suffix for the re-admission."""
        e = self._entries[uid]
        e.replayed = list(e.emitted)
        e.replica = replica
        e.replays += 1

    def handoff(self, uid: Any, replica: str) -> None:
        """Move an entry to a new holder by PAGE handoff: the KV moved,
        so nothing converts to prompt suffix — ``replayed`` is
        untouched, and the destination's ``progress()`` keeps reporting
        the full post-replay stream (its imported slot is seeded with
        exactly ``emitted[len(replayed):]``).  Contrast
        :meth:`reassign`, the recompute path."""
        e = self._entries[uid]
        e.replica = replica
        e.handoffs += 1

    def entries(self):
        """Every entry, admission order — what the durable journal
        (:meth:`~apex_tpu_torch.fleet.journal.RequestJournal.sync`) and the
        deadline sweep iterate."""
        return list(self._entries.values())

    def inflight_on(self, replica: str) -> List[LogEntry]:
        """Entries the named replica holds that have not completed —
        queued and admitted alike (what a death must migrate)."""
        return [e for e in self._entries.values()
                if not e.done and e.replica == replica]

    def pending(self) -> int:
        return sum(1 for e in self._entries.values() if not e.done)


def resume_request(entry: LogEntry) -> Request:
    """The re-admission for a migrated entry: committed tokens become
    prompt suffix, the budget shrinks by their count, uid and seed are
    unchanged.  Absolute positions (and therefore the key-schedule
    folds) match the original run's, so the continuation reproduces the
    stream the dead replica would have produced.

    The math is by token COUNT, not by harvest-record or step count —
    which is what keeps it exact under speculative decoding, where one
    verify step commits a variable number of tokens and the record/step
    ledgers diverge from the stream length.  Token-identity survives
    too: the Gumbel-coupled acceptance rule commits exactly the tokens
    the plain per-position key schedule would draw, so a resumed
    replica re-drafting from a different mid-stream point converges on
    the same stream regardless of how the dead replica's verify-step
    boundaries fell."""
    base = entry.request
    emitted = list(entry.emitted)
    budget = base.max_new_tokens - len(emitted)
    if budget < 1:
        raise ValueError(
            f"uid {base.uid!r} has no budget left to resume "
            f"({len(emitted)}/{base.max_new_tokens} tokens emitted) — "
            "a spent request should have completed, not migrated")
    return Request(uid=base.uid,
                   prompt=list(base.prompt) + emitted,
                   max_new_tokens=budget,
                   seed=base.seed)
