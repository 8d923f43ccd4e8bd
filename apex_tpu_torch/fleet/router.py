"""Fleet-tier serving: one router over N continuous-batching replicas.

Counterpart of ``apex_tpu/fleet/router.py``, host Python over the
batcher's fleet seams (``serving/serve.py``).  N
:class:`~apex_tpu_torch.serving.serve.ContinuousBatcher` replicas, each
over its own cache and pools, are driven by ONE set of step functions
(``decode_fns``); on the card each replica replays its own CUDA graphs
(``serving/graphs.py`` keys them by pools), so after warm-up a fleet
captures nothing new: the port's form of JAX's "zero extra
compilations".  The :class:`FleetRouter` decides, per request, WHO serves
it and WHEN, from host mirrors only (no new host sync):

- **routing key**: the prefix cache's cumulative page hash
  (:func:`~apex_tpu_torch.serving.kv_cache.prompt_page_hashes`), probed
  read-only against every replica's prefix index
  (``PagedKVCache.match_len``): a shared system prompt lands where its
  pages already are, and its chunks are never computed again.
- **load score**: free KV pages, queue depth, live slots.
- **SLO classes**: per-class queues drained in priority order at every
  pump (stable, FIFO within a class), each with admission control
  (``max_queue``: reject rather than grow the backlog).

Policy is one declarative object (:class:`FleetPolicy`).
``routing="round_robin"`` is the baseline that ignores affinity, load and
class priority.

Failover rides the request log (:mod:`apex_tpu_torch.fleet.failover`): a
killed replica's queued and in-flight requests re-admit elsewhere with
their committed tokens replayed as prompt suffix; none is lost, and the
continuations are token-identical (greedy or seeded).  On the same log:

- **health**: a pump that raises is a replica fault
  (``max_replica_faults`` in a row quarantine it), a pump slower than
  ``pump_timeout_s`` a stall (quarantined at once); quarantine drains the
  replica like a kill.
- **deadlines**: unmeetable ones are rejected at admission
  (``deadline_unmeetable``); a missed one cancels the request and either
  re-routes it (``max_retries``, re-armed) or completes it with the
  reason ``"deadline"`` and a committed prefix of the stream.
- **hedging**: after ``hedge_after_s`` a running request gets ONE
  duplicate on another replica; first commit wins, and both copies make
  the same stream.
- **brownout**: under page pressure or queue growth the router walks
  :class:`BrownoutPolicy`'s ladder (speculation off, prefill chunks
  throttled, the lowest class shed) and back down with hysteresis; the
  levers change scheduling, never a token.
- **disaggregation** (``FleetPolicy.roles``): prefill-role replicas
  ingest prompts and hand decode-ready streams to decode-role replicas by
  moving their KV pages (``export_request`` / ``import_request``), a
  journaled ownership transfer.

A ``journal=`` (:class:`~apex_tpu_torch.fleet.journal.RequestJournal`)
makes the log durable: admissions are journaled write-ahead and every
step's deltas land in one append, so a dead process recovers with
:func:`~apex_tpu_torch.fleet.journal.recover_journal` +
:meth:`FleetRouter.resume_from_journal`.  ``logger=`` receives the JAX
router's telemetry events and ``watchdog=`` is beaten before every pump.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.fleet.failover import RequestLog, resume_request
from apex_tpu_torch.serving.kv_cache import prompt_page_hashes
from apex_tpu_torch.serving.serve import ContinuousBatcher, Request

__all__ = ["SLOClass", "FleetPolicy", "BrownoutPolicy", "Replica",
           "FleetCompletion", "FleetRouter", "INTERACTIVE", "BATCH"]

_ROUTINGS = ("affinity", "least_loaded", "round_robin")

#: replica roles: ``prefill`` ingests prompts and hands decode-ready
#: streams off by page movement, ``decode`` receives streams only by
#: handoff, ``unified`` does both (the pre-disaggregation behavior)
_REPLICA_ROLES = ("prefill", "decode", "unified")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One latency class.  ``priority`` orders admission (lower admits
    first); ``max_queue`` caps the class's fleet-wide QUEUED requests —
    beyond it, :meth:`FleetRouter.submit` rejects (admission control:
    an interactive class would rather shed than queue past its SLO,
    a batch class usually leaves it ``None``/unbounded).

    ``deadline_s`` arms a per-request deadline at admission (see the
    module docstring's deadline semantics); ``max_retries`` bounds how
    many times a deadline miss re-routes before the terminal
    ``"deadline"`` completion; ``hedge_after_s`` spawns one duplicate
    on another replica after that much arrival-anchored wall time —
    all None/0 by default (no timed behavior)."""

    name: str
    priority: int = 0
    max_queue: Optional[int] = None
    deadline_s: Optional[float] = None
    max_retries: int = 0
    hedge_after_s: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLO class needs a name")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.hedge_after_s is not None and self.hedge_after_s <= 0:
            raise ValueError("hedge_after_s must be > 0 (or None)")


INTERACTIVE = SLOClass("interactive", priority=0)
BATCH = SLOClass("batch", priority=1)


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """The degradation ladder: three rungs, each an explicit trade of
    quality-of-service for headroom, shed in policy order —

    1. speculation off (drafting burns pages and verify FLOPs for
       latency; pressure wants the pages back),
    2. prefill chunks throttled to every ``chunk_throttle``-th window
       iteration (admissions ingest slower, decode keeps its budget),
    3. the LOWEST-priority SLO class rejected at admission
       (``"brownout"``: batch sheds before interactive degrades).

    A rung engages when the fleet's minimum free-page fraction drops
    to ``page_frac[i]`` or its queued depth reaches
    ``queue_depth[i]``; it releases one rung per step only when the
    triggers clear by ``recover_margin`` (hysteresis — a fleet
    hovering at a threshold must not flap).  Declarative and frozen,
    like :class:`FleetPolicy` itself: every transition the router
    makes is readable off this object (``FleetRouter.brownout_level``
    and its ``brownout_transitions`` stat)."""

    page_frac: Tuple[float, float, float] = (0.25, 0.12, 0.05)
    queue_depth: Tuple[int, int, int] = (8, 16, 32)
    chunk_throttle: int = 2
    recover_margin: float = 1.5

    def __post_init__(self):
        if len(self.page_frac) != 3 or len(self.queue_depth) != 3:
            raise ValueError(
                "the ladder has exactly 3 rungs: page_frac and "
                "queue_depth must each have 3 thresholds")
        if not all(0.0 <= f < 1.0 for f in self.page_frac):
            raise ValueError(
                f"page_frac thresholds must be in [0, 1): "
                f"{self.page_frac}")
        if list(self.page_frac) != sorted(self.page_frac,
                                          reverse=True):
            raise ValueError(
                f"page_frac must be non-increasing (rung i+1 is MORE "
                f"pressure): {self.page_frac}")
        if any(d < 1 for d in self.queue_depth):
            raise ValueError(
                f"queue_depth thresholds must be >= 1: "
                f"{self.queue_depth}")
        if list(self.queue_depth) != sorted(self.queue_depth):
            raise ValueError(
                f"queue_depth must be non-decreasing: "
                f"{self.queue_depth}")
        if self.chunk_throttle < 2:
            raise ValueError(
                "chunk_throttle must be >= 2 (1 would make rung 2 a "
                "no-op)")
        if self.recover_margin <= 1.0:
            raise ValueError(
                "recover_margin must be > 1 (hysteresis needs a gap)")


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """The fleet's ONE declarative policy: SLO classes, routing mode,
    load-score weights.  Every router decision reads off this object.

    ``routing``: ``"affinity"`` (prefix-match first, least-loaded
    tie-break/fallback), ``"least_loaded"`` (load only), or
    ``"round_robin"`` (the baseline: cycles replicas and ignores class
    priority).  The load score is
    ``w_queue * queue_depth + w_slots * live_slots
    - w_pages * free_page_fraction`` — smaller is less loaded."""

    classes: Tuple[SLOClass, ...] = (INTERACTIVE, BATCH)
    routing: str = "affinity"
    w_queue: float = 1.0
    w_slots: float = 1.0
    w_pages: float = 1.0
    #: static per-fleet-step time floor for the admission-time
    #: deadline feasibility check (0 disables it): a request needing
    #: ``min_steps`` serving steps with ``min_steps * step_floor_s``
    #: past its deadline is rejected as ``deadline_unmeetable``
    step_floor_s: float = 0.0
    #: a pump slower than this is a stalled replica — quarantined on
    #: the spot (None disables the stall check)
    pump_timeout_s: Optional[float] = None
    #: consecutive pump exceptions before a replica is quarantined
    #: (a successful pump resets the count — transient faults heal)
    max_replica_faults: int = 3
    #: the degradation ladder (None = no brownout behavior)
    brownout: Optional[BrownoutPolicy] = None
    #: per-replica roles by INDEX (``"prefill"`` / ``"decode"`` /
    #: ``"unified"``); None = all unified.  Any non-unified role makes
    #: the fleet DISAGGREGATED: prompts route to prefill-capable
    #: replicas only, and finished prefills hand their KV pages off to
    #: decode-capable replicas (:meth:`FleetRouter._handoff_sweep`) —
    #: prefill compute and decode weight-streaming stop stealing each
    #: other's step budget
    roles: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.routing not in _ROUTINGS:
            raise ValueError(
                f"routing must be one of {_ROUTINGS}, "
                f"got {self.routing!r}")
        if self.roles is not None:
            bad = [x for x in self.roles if x not in _REPLICA_ROLES]
            if bad:
                raise ValueError(
                    f"unknown replica roles {bad} — roles must be "
                    f"among {_REPLICA_ROLES}")
            if "prefill" in self.roles and not any(
                    x in ("decode", "unified") for x in self.roles):
                raise ValueError(
                    "prefill-role replicas hand every stream off — "
                    "the fleet needs at least one decode-capable "
                    "(decode or unified) replica")
            if "decode" in self.roles and not any(
                    x in ("prefill", "unified") for x in self.roles):
                raise ValueError(
                    "pure-decode replicas receive work only by page "
                    "handoff — the fleet needs at least one "
                    "prefill-capable replica")
        if not self.classes:
            raise ValueError("policy needs at least one SLO class")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names: {names}")
        if self.step_floor_s < 0:
            raise ValueError("step_floor_s must be >= 0")
        if self.pump_timeout_s is not None and self.pump_timeout_s <= 0:
            raise ValueError("pump_timeout_s must be > 0 (or None)")
        if self.max_replica_faults < 1:
            raise ValueError("max_replica_faults must be >= 1")

    def cls(self, name: str) -> SLOClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise ValueError(
            f"unknown SLO class {name!r} "
            f"(policy has {[c.name for c in self.classes]})")


class Replica:
    """One fleet member: a named batcher plus its liveness and the
    fault-injection seam.  ``kill()`` marks it dead immediately;
    ``fail_after(n)`` arms a deterministic death after ``n`` harvest
    windows — the in-process analog of a SIGKILL, placed at the only
    boundary an in-process replica has (between windows; a real preemption
    additionally loses the unharvested window, which the replay
    contract already treats as uncommitted)."""

    def __init__(self, name: str, batcher: ContinuousBatcher,
                 role: str = "unified"):
        if role not in _REPLICA_ROLES:
            raise ValueError(
                f"unknown replica role {role!r} — must be among "
                f"{_REPLICA_ROLES}")
        self.name = str(name)
        self.batcher = batcher
        #: disaggregation role (``FleetPolicy.roles`` overrides it at
        #: router construction)
        self.role = role
        self.alive = True
        self.windows = 0
        self.fail_at: Optional[int] = None
        #: health-monitor state: total and consecutive pump faults,
        #: why the router quarantined it (None = not quarantined —
        #: a ``kill()`` is death, not quarantine), the last fault
        self.faults = 0
        self.consecutive_faults = 0
        self.quarantined: Optional[str] = None
        self.last_error: Optional[str] = None

    def kill(self) -> None:
        self.alive = False

    def fail_after(self, windows: int) -> None:
        if windows < 0:
            raise ValueError("fail_after expects >= 0 windows")
        self.fail_at = int(windows)


@dataclasses.dataclass
class FleetCompletion:
    """A completed fleet request: the FULL stitched token stream (every
    migration's committed tokens plus the final continuation), against
    the ORIGINAL prompt length.  ``ttft_s``/``duration_s`` are
    arrival-anchored (queue wait included — what an SLO sees), accurate
    to the harvest boundary."""

    uid: Any
    tokens: List[int]
    prompt_len: int
    reason: str
    slo: str
    replica: str
    replays: int = 0
    ttft_s: Optional[float] = None
    duration_s: Optional[float] = None
    #: True when a hedged duplicate won the race (the stream is still
    #: token-identical — determinism is why hedging is safe at all)
    hedged: bool = False
    #: page-level ownership transfers the request rode (disaggregated
    #: prefill→decode moves — no recompute, unlike ``replays``)
    handoffs: int = 0

    @property
    def itl_ms(self) -> Optional[float]:
        """Mean inter-token latency (ms) over the request's own stream
        — first token to completion, arrival-clock, harvest-granular."""
        if self.ttft_s is None or self.duration_s is None or \
                len(self.tokens) < 2:
            return None
        return ((self.duration_s - self.ttft_s)
                / (len(self.tokens) - 1) * 1e3)


class FleetRouter:
    """Route requests over replicas per a :class:`FleetPolicy`.

    ``replicas`` are :class:`Replica` objects or bare batchers (wrapped
    as ``r0``, ``r1``, ...).  All replicas must share one cache config
    family: the same ``page_size`` (the routing key's unit) and prompt
    window.  ``journal`` is an optional
    :class:`~apex_tpu_torch.fleet.journal.RequestJournal`: admissions are
    journaled write-ahead inside :meth:`submit` and every :meth:`step`
    ends with one batched delta sync.  ``clock`` (default
    ``time.perf_counter``) times arrivals, deadlines, hedges and pump
    stalls; a test injects its own.  ``logger`` is an optional
    :class:`~apex_tpu_torch.telemetry.metrics.MetricsLogger` (anything
    with ``event``) that receives the JAX router's events;
    ``watchdog`` is an optional
    :class:`~apex_tpu_torch.resilience.watchdog.Watchdog` beaten before
    every pump, with the replica's serving fields, so a wedged pump
    leaves a heartbeat file that names the stalled replica.

    Drive it with :meth:`submit` + :meth:`step` (one harvest window on
    every live replica a step: no replica blocks another), or
    :meth:`drain` to run pending work to completion.  Results land in
    ``self.completions`` (uid -> :class:`FleetCompletion`)."""

    def __init__(
        self,
        replicas: Sequence[Any],
        policy: Optional[FleetPolicy] = None,
        *,
        logger: Optional[Any] = None,
        clock=time.perf_counter,
        journal: Optional[Any] = None,
        watchdog: Optional[Any] = None,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas: List[Replica] = [
            r if isinstance(r, Replica) else Replica(f"r{i}", r)
            for i, r in enumerate(replicas)
        ]
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        sizes = {r.batcher.cache.config.page_size
                 for r in self.replicas}
        if len(sizes) != 1:
            raise ValueError(
                f"replicas disagree on page_size {sorted(sizes)} — "
                "the routing key is per-page, all replicas must share "
                "one cache config family")
        self.policy = policy if policy is not None else FleetPolicy()
        if self.policy.roles is not None:
            if len(self.policy.roles) != len(self.replicas):
                raise ValueError(
                    f"policy.roles names {len(self.policy.roles)} "
                    f"replicas but the fleet has "
                    f"{len(self.replicas)}")
            for r, role in zip(self.replicas, self.policy.roles):
                r.role = role
        #: any non-unified role => disaggregated scheduling: role-aware
        #: routing plus the per-step handoff sweep
        self._disagg = any(r.role != "unified" for r in self.replicas)
        if self._disagg:
            fams = {r.batcher.cache.compat_key()
                    for r in self.replicas}
            if len(fams) != 1:
                raise ValueError(
                    "disaggregated fleets move KV pages between "
                    "replicas — every cache must share one page "
                    f"layout (compat_key), got {len(fams)} distinct")
            for r in self.replicas:
                if r.role == "prefill":
                    r.batcher.decode_enabled = False
        #: staged handoff packets awaiting destination capacity:
        #: {"uid", "src", "dst", "packet", "replays",
        #: "handoffs"} — charged to the DESTINATION's load score only
        self._handoffs: List[dict] = []
        self.logger = logger
        self._clock = clock
        self.journal = journal
        self.watchdog = watchdog
        self._page_size = sizes.pop()
        self._max_prompt_len = min(
            r.batcher.max_prompt_len for r in self.replicas)
        self.log = RequestLog()
        self.completions: Dict[Any, FleetCompletion] = {}
        self.rejected: Dict[Any, str] = {}          # uid -> reason
        self._queues: Dict[str, collections.deque] = {
            r.name: collections.deque() for r in self.replicas}
        self._cls: Dict[Any, str] = {}              # uid -> class name
        self._by_name: Dict[str, Replica] = {
            r.name: r for r in self.replicas}
        self._rr = 0
        self._steps = 0
        #: live hedges: uid -> {"replica", "base" (stream at spawn)}
        self._hedges: Dict[Any, dict] = {}
        self._hedged_once: set = set()   # one hedge per request, ever
        self.brownout_level = 0
        #: skip the per-step deadline sweep until any deadline exists
        self._deadlines_live = any(
            c.deadline_s is not None for c in self.policy.classes)
        self._has_hedging = any(
            c.hedge_after_s is not None for c in self.policy.classes)
        self.stats = {
            "submitted": 0, "rejected": 0, "migrations": 0,
            "affinity_routed": 0,
            "replica_faults": 0, "quarantined": 0,
            "deadline_misses": 0, "deadline_retries": 0,
            "hedges": 0, "hedge_wins": 0, "hedge_losses": 0,
            "brownout_transitions": 0, "resumed_from_journal": 0,
            "handoffs": 0, "handoff_pages": 0, "handoff_bytes": 0,
            "routed": {r.name: 0 for r in self.replicas},
        }

    # ------------------------------------------------------------ events
    def _event(self, kind: str, **fields) -> None:
        if self.logger is not None:
            self.logger.event(kind, **fields)

    # ------------------------------------------------------------- state
    @property
    def pending(self) -> int:
        """Requests submitted but not yet completed."""
        return self.log.pending()

    def queue_depth(self, cls_name: Optional[str] = None) -> int:
        """Fleet-wide QUEUED (not yet admitted) requests, optionally
        restricted to one SLO class."""
        n = 0
        for q in self._queues.values():
            for req in q:
                if cls_name is None or self._cls[req.uid] == cls_name:
                    n += 1
        return n

    def _inbound(self, name: str) -> int:
        """Staged handoff packets bound for the named replica — load
        it has accepted ownership of but not yet imported."""
        return sum(1 for p in self._handoffs if p["dst"] == name)

    def _load(self, r: Replica) -> float:
        """Host-mirror load score: free pages, queue depth and live
        slots, read directly (no device sync).  A
        mid-handoff request counts against its DESTINATION only (the
        ``_inbound`` term): the source released its slot at export, so
        without the term the request would vanish from every score
        while staged — and with the old holder-based accounting it was
        counted on BOTH sides until the import landed."""
        p = self.policy
        cfg = r.batcher.cache.config
        free_frac = (r.batcher.cache.allocator.num_free
                     / max(1, cfg.num_pages - 1))
        return (p.w_queue * len(self._queues[r.name])
                + p.w_slots * (r.batcher.live_slots
                               + self._inbound(r.name))
                - p.w_pages * free_frac)

    # ------------------------------------------------------------- route
    def _route(self, request: Request) -> Tuple[Replica, int]:
        """Pick the serving replica; returns ``(replica,
        affinity_tokens)``.  Deterministic: ties break on replica
        order."""
        alive = [r for r in self.replicas if r.alive]
        if not alive:
            raise RuntimeError("no replica is alive")
        # disaggregation: prompts go to prefill-capable replicas; a
        # pure-decode replica receives work by page handoff, never by
        # routing — unless nothing prefill-capable is left alive
        cands = [r for r in alive if r.role != "decode"] or alive
        if self.policy.routing == "round_robin":
            r = cands[self._rr % len(cands)]
            self._rr += 1
            return r, 0
        key = (prompt_page_hashes(request.prompt, self._page_size)
               if self.policy.routing == "affinity" else [])
        best, best_score, best_aff = None, None, 0
        for i, r in enumerate(cands):
            aff = r.batcher.cache.match_len(key) if key else 0
            # chunk budget: in a disaggregated fleet, prompts steer by
            # the chunks a prefill replica still owes, not just queue
            # length — the prefill-pressure half of role-aware routing
            pressure = (self.policy.w_queue
                        * r.batcher.pending_prefill_chunks
                        if self._disagg else 0.0)
            score = (-aff, self._load(r) + pressure, i)
            if best_score is None or score < best_score:
                best, best_score, best_aff = r, score, aff
        return best, best_aff

    # ------------------------------------------------------------ submit
    def _deadline_feasible(self, deadline_s: float, plen: int,
                           max_new: int) -> bool:
        """Static admission arithmetic, the budget-headroom
        discipline applied to time: the request needs at least one
        serving step per prefill chunk (one for a monolithic prefill)
        plus one decode step per generated token after the first —
        if that floor already overruns the deadline, reject now
        instead of cancelling later."""
        if deadline_s <= 0:
            return False
        floor = self.policy.step_floor_s
        if floor <= 0:
            return True
        chunk = self.replicas[0].batcher.prefill_chunk
        chunks = -(-plen // chunk) if chunk else 1
        min_steps = chunks + max_new - 1
        return min_steps * floor <= deadline_s

    def submit(self, request: Request, slo: Optional[str] = None,
               *, t_arrive: Optional[float] = None,
               deadline_s: Optional[float] = None) -> bool:
        """Admission-control one request into the fleet.  Returns False
        (and emits ``request_rejected``) when the request can never be
        served (prompt + replay headroom past the prompt window, or
        more pages than any replica's pool), its class queue is full,
        its deadline is already unmeetable, or the brownout ladder is
        shedding its class; True once it is routed and logged.
        ``slo`` defaults to the policy's first (highest-priority)
        class; ``deadline_s`` overrides the class's own (relative to
        arrival).

        The prompt-window check reserves REPLAY headroom: migration
        re-admits ``prompt + emitted`` as a prompt, so
        ``len(prompt) + max_new_tokens - 1`` must fit
        ``max_prompt_len`` — enforced here, not discovered at failover
        time."""
        cls = self.policy.cls(slo) if slo is not None \
            else self.policy.classes[0]
        cfg = self.replicas[0].batcher.cache.config
        plen = len(request.prompt)
        total = plen + request.max_new_tokens
        dl = deadline_s if deadline_s is not None else cls.deadline_s
        reason = None
        if plen + request.max_new_tokens - 1 > self._max_prompt_len:
            reason = "too_large"
        elif (total > cfg.max_len
                or cfg.tokens_to_pages(total) > cfg.num_pages - 1):
            reason = "too_large"
        elif dl is not None and not self._deadline_feasible(
                float(dl), plen, request.max_new_tokens):
            reason = "deadline_unmeetable"
        elif cls.max_queue is not None and \
                self.queue_depth(cls.name) >= cls.max_queue:
            reason = "queue_full"
        elif (self.brownout_level >= 3
                and len(self.policy.classes) > 1
                and cls.priority == max(
                    c.priority for c in self.policy.classes)):
            reason = "brownout"
        if reason is not None:
            self.rejected[request.uid] = reason
            self.stats["rejected"] += 1
            self._event("request_rejected", uid=request.uid,
                        slo=cls.name, reason=reason)
            return False
        replica, aff = self._route(request)
        now = self._clock() if t_arrive is None else float(t_arrive)
        e = self.log.admit(request, cls.name, replica.name, now)
        if dl is not None:
            e.deadline_rel = float(dl)
            e.deadline = now + float(dl)
            self._deadlines_live = True
        self._cls[request.uid] = cls.name
        if self.journal is not None:
            self.journal.admit(e)       # write-ahead: durable first
        self._queues[replica.name].append(request)
        self.stats["submitted"] += 1
        self.stats["routed"][replica.name] += 1
        if aff > 0:
            self.stats["affinity_routed"] += 1
        self._event("request_routed", uid=request.uid,
                    replica=replica.name, slo=cls.name, affinity=aff)
        return True

    # -------------------------------------------------------------- step
    def _pump_order(self, name: str) -> collections.deque:
        """The replica's admission queue for this pump: class priority
        first (stable — FIFO within a class), unless the round-robin
        baseline, which is FIFO across classes too."""
        items = list(self._queues[name])
        if self.policy.routing != "round_robin":
            prio = {c.name: c.priority for c in self.policy.classes}
            items.sort(key=lambda req: prio[self._cls[req.uid]])
        return collections.deque(items)

    def step(self) -> bool:
        """One fleet scheduling turn: fire any armed fault seams,
        migrate work off dead (killed or quarantined) replicas,
        re-evaluate the brownout ladder, pump every live replica one
        harvest window (health-checked after),
        absorb progress and completions into the log, sweep deadlines
        and hedges, and sync the durable journal.  Returns True while
        requests remain pending."""
        self._steps += 1
        for r in self.replicas:
            if r.alive and r.fail_at is not None \
                    and r.windows >= r.fail_at:
                r.kill()
        for r in self.replicas:
            if not r.alive:
                self._drop_hedges_on(r.name, "replica_dead")
                if self._queues[r.name] or self.log.inflight_on(r.name):
                    self._migrate(r)
        self._brownout_eval()
        for r in self.replicas:
            if not r.alive:
                continue
            work = self._pump_order(r.name)
            if not work and r.batcher.live_slots == 0:
                continue
            self._beat(r)
            t0 = self._clock()
            try:
                r.batcher.pump(work)
            except Exception as err:        # noqa: BLE001 — a faulting
                # replica must not take the fleet down; quarantine
                # after max_replica_faults and migrate its work
                self._queues[r.name] = work
                self._replica_fault(r, err)
                continue
            dur = self._clock() - t0
            r.consecutive_faults = 0
            r.windows += 1
            self._queues[r.name] = work
            self._absorb(r)
            if self.policy.pump_timeout_s is not None \
                    and dur > self.policy.pump_timeout_s:
                self._quarantine(r, "stall")
        self._handoff_sweep()
        self._enforce_deadlines()
        self._spawn_hedges()
        if self.journal is not None:
            self.journal.sync(self.log)
        return self.pending > 0

    # ------------------------------------------------------------ health
    def _beat(self, r: Replica) -> None:
        """Heartbeat BEFORE the pump, carrying the replica's serving
        fields: if the pump then wedges, the heartbeat file names the
        stalled replica."""
        if self.watchdog is None:
            return
        self.watchdog.beat(step=self._steps, extra={
            "replica": r.name,
            "serving_step": int(r.batcher.steps),
            "live_slots": int(r.batcher.live_slots),
        })

    def _replica_fault(self, r: Replica, err: BaseException) -> None:
        r.faults += 1
        r.consecutive_faults += 1
        r.last_error = repr(err)
        self.stats["replica_faults"] += 1
        self._event("replica_fault", replica=r.name, error=repr(err),
                    consecutive=r.consecutive_faults)
        if r.consecutive_faults >= self.policy.max_replica_faults:
            self._quarantine(r, "faults")

    def _quarantine(self, r: Replica, cause: str) -> None:
        """A quarantine is a kill the router decides itself: the
        replica is marked dead and the NEXT step's migration pass
        drains its queue and in-flight slots exactly like
        ``Replica.kill()`` — pending work keeps :meth:`drain`
        stepping, so nothing strands."""
        if not r.alive:
            return
        r.alive = False
        r.quarantined = cause
        self.stats["quarantined"] += 1
        self._event("replica_quarantined", replica=r.name,
                    cause=cause, faults=r.faults, windows=r.windows,
                    error=r.last_error)

    def drain(self, max_steps: int = 100_000
              ) -> Dict[Any, FleetCompletion]:
        """Step until nothing is pending (bounded by ``max_steps`` so a
        scheduling bug hangs a test, not a host)."""
        steps = 0
        while self.step():
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"fleet did not drain in {max_steps} steps "
                    f"({self.pending} requests still pending)")
        return self.completions

    # ----------------------------------------------------------- absorb
    def _absorb(self, r: Replica) -> None:
        now = self._clock()
        # hedge progress is invisible here by design: record_progress
        # skips entries whose holder is a different replica, so only
        # the primary's stream feeds the log until a commit decides
        self.log.record_progress(r.name, r.batcher.progress(), now)
        for uid, comp in r.batcher.completions.items():
            if uid in self.completions or uid not in self.log:
                continue
            e = self.log.get(uid)
            h = self._hedges.get(uid)
            if h is not None and h["replica"] == r.name:
                # the HEDGED duplicate finished on this replica
                self._hedges.pop(uid)
                if e.done:
                    # the primary reached a terminal state first
                    self.stats["hedge_losses"] += 1
                    self._event("hedge_loss", uid=uid, replica=r.name,
                                cause="primary_won")
                    continue
                # first-commit-wins: cancel the primary, record the
                # hedge's completion.  The full stream is the spawn
                # base plus the hedge's tokens — token-identical to
                # what the primary would have produced (determinism
                # is the safety argument), so stitching past the
                # primary's extra progress is exact.
                full = list(h["base"]) + list(comp.tokens)
                delta = full[len(e.replayed):]
                pq = self._queues.get(e.replica)
                if pq:
                    self._queues[e.replica] = collections.deque(
                        x for x in pq if x.uid != uid)
                prim = self._by_name.get(e.replica)
                if prim is not None and prim.alive:
                    prim.batcher.cancel(uid)
                e.replica = r.name
                e = self.log.complete(uid, delta, comp.reason, now)
                self.completions[uid] = FleetCompletion(
                    uid=uid, tokens=list(e.emitted),
                    prompt_len=len(e.request.prompt),
                    reason=e.reason, slo=e.slo, replica=r.name,
                    replays=e.replays, hedged=True,
                    handoffs=e.handoffs,
                    ttft_s=(None if e.t_first is None
                            else e.t_first - e.t_arrive),
                    duration_s=now - e.t_arrive,
                )
                self.stats["hedge_wins"] += 1
                self._event("hedge_win", uid=uid, replica=r.name,
                            tokens=len(e.emitted))
                continue
            if e.done or e.replica != r.name:
                continue
            e = self.log.complete(uid, comp.tokens, comp.reason, now)
            self.completions[uid] = FleetCompletion(
                uid=uid, tokens=list(e.emitted),
                prompt_len=len(e.request.prompt),
                reason=e.reason, slo=e.slo, replica=r.name,
                replays=e.replays, handoffs=e.handoffs,
                ttft_s=(None if e.t_first is None
                        else e.t_first - e.t_arrive),
                duration_s=now - e.t_arrive,
            )
            if uid in self._hedges:
                self._drop_hedge(uid, "primary_won")

    # ----------------------------------------------------------- handoff
    def _decode_target(self) -> Optional[Replica]:
        """The least-loaded decode-capable replica (pure decode
        preferred over unified — that is what the role exists for);
        None when nothing decode-capable is alive."""
        best, best_score = None, None
        for i, r in enumerate(self.replicas):
            if not r.alive or r.role == "prefill":
                continue
            score = (0 if r.role == "decode" else 1, self._load(r), i)
            if best_score is None or score < best_score:
                best, best_score = r, score
        return best

    def _handoff_sweep(self) -> None:
        """The disaggregation engine, once per fleet step AFTER every
        pump+absorb (so the log's ``emitted`` and the packet's tokens
        agree): export decode-ready streams off prefill replicas as
        staged :class:`~apex_tpu_torch.serving.serve.HandoffPacket`\\ s —
        each a journaled ownership transfer — then land staged packets
        on their destination as capacity allows (same step when the
        destination has a free slot).  The contract end to end:

        - **durability first**: the journal's ``handoff`` record is
          written BEFORE any pages move, and the packet's tokens are
          already journaled progress — a crash at any point recovers
          the stream token-identically (at worst via recompute).
        - **no double-count**: the source slot is released at export;
          the staged packet charges the destination's load score via
          ``_inbound`` until imported.
        - **staleness**: a packet whose log entry completed, changed
          holder (deadline retry, dead-destination migration) or
          advanced its replay/handoff counters is dropped — the
          recompute path owns the request; page content is always
          regenerable.
        - **fallback**: with every decode-capable replica dead, the
          prefill replicas flip ``decode_enabled`` back on (one-way)
          so streams still finish."""
        if not self._disagg:
            return
        if not any(r.alive and r.role != "prefill"
                   for r in self.replicas):
            for r in self.replicas:
                if r.alive and not r.batcher.decode_enabled:
                    r.batcher.decode_enabled = True
                    self._event("role_fallback", replica=r.name)
            return
        # ---- export: prefill replicas shed decode-ready streams
        for r in self.replicas:
            if not r.alive or r.role != "prefill" \
                    or r.batcher.decode_enabled:
                continue    # decode_enabled: a past fallback flipped it
            for uid in r.batcher.handoff_ready():
                if uid not in self.log:
                    continue
                e = self.log.get(uid)
                if e.done or e.replica != r.name:
                    continue    # a hedge duplicate — never exported
                dst = self._decode_target()
                if dst is None:
                    return
                if (self._inbound(dst.name)
                        >= dst.batcher.cache.config.max_seqs):
                    continue    # staging bounded by destination slots
                if self.journal is not None:
                    self.journal.handoff(uid, r.name, dst.name)
                t0 = self._clock()
                packet = r.batcher.export_request(uid)
                if packet is None:
                    continue
                self.log.handoff(uid, dst.name)
                self._handoffs.append({
                    "uid": uid, "src": r.name, "dst": dst.name,
                    "packet": packet,
                    "export_s": self._clock() - t0,
                    "replays": e.replays, "handoffs": e.handoffs,
                })
        # ---- import: land staged packets where capacity allows
        for pk in list(self._handoffs):
            uid = pk["uid"]
            e = self.log.get(uid) if uid in self.log else None
            if e is None or e.done or e.replica != pk["dst"] \
                    or e.replays != pk["replays"] \
                    or e.handoffs != pk["handoffs"]:
                # completed / cancelled / re-routed since staging: the
                # packet is stale, the recompute path owns the request
                self._handoffs.remove(pk)
                continue
            dst = self._by_name.get(pk["dst"])
            if dst is None or not dst.alive:
                continue    # the migration pass re-routes next step
            t0 = self._clock()
            if not dst.batcher.import_request(pk["packet"]):
                continue                # backpressure: stay staged
            self._handoffs.remove(pk)
            self.stats["handoffs"] += 1
            self.stats["handoff_pages"] += pk["packet"].n_pages
            self.stats["handoff_bytes"] += pk["packet"].wire_bytes
            self._event(
                "kv_handoff", uid=uid, src=pk["src"], dst=pk["dst"],
                pages=pk["packet"].n_pages,
                bytes=pk["packet"].wire_bytes,
                tokens=len(pk["packet"].tokens),
                dur_s=round(pk["export_s"] + (self._clock() - t0), 6))

    # --------------------------------------------------------- deadlines
    def _cancel_everywhere(self, e) -> Optional[List[int]]:
        """Remove a request from its holder (queue entry, in-flight
        slot, and any live hedge); returns the holder's harvested
        delta (relative to ``e.replayed``), or None if it was only
        queued."""
        uid = e.request.uid
        q = self._queues.get(e.replica)
        if q is not None and any(x.uid == uid for x in q):
            self._queues[e.replica] = collections.deque(
                x for x in q if x.uid != uid)
        rep = self._by_name.get(e.replica)
        toks = (rep.batcher.cancel(uid)
                if rep is not None and rep.alive else None)
        self._drop_hedge(uid, "cancelled")
        return toks

    def _enforce_deadlines(self) -> None:
        """The per-step deadline sweep: a missed deadline cancels the
        request wherever it runs, then either re-routes it with a
        re-armed deadline (``max_retries`` budget, replay semantics
        identical to migration — the partial stream rides along) or
        completes it with the terminal reason ``"deadline"``.  Either
        way the request's stream stays a committed prefix of the
        deterministic reference — never truncated mid-commit, never
        corrupted."""
        if not self._deadlines_live:
            return
        now = self._clock()
        for e in self.log.entries():
            if e.done or e.deadline is None or now < e.deadline:
                continue
            uid = e.request.uid
            cls = self.policy.cls(e.slo)
            self.stats["deadline_misses"] += 1
            budget_left = e.request.max_new_tokens - len(e.emitted)
            retry = (e.deadline_retries < cls.max_retries
                     and budget_left >= 1
                     and any(r.alive for r in self.replicas))
            toks = self._cancel_everywhere(e)
            self._event("deadline_miss", uid=uid, slo=e.slo,
                        emitted=len(e.emitted), retry=retry,
                        replays=e.replays)
            if retry:
                e.deadline_retries += 1
                self.stats["deadline_retries"] += 1
                req = resume_request(e)
                target, aff = self._route(req)
                self.log.reassign(uid, target.name)
                self._queues[target.name].append(req)
                self.stats["routed"][target.name] += 1
                e.deadline = now + (e.deadline_rel
                                    if e.deadline_rel is not None
                                    else cls.deadline_s)
                self._event("request_migrated", uid=uid,
                            replica=target.name, replays=e.replays,
                            affinity=aff, cause="deadline")
            else:
                e = self.log.complete(uid, toks or [], "deadline", now)
                self.completions[uid] = FleetCompletion(
                    uid=uid, tokens=list(e.emitted),
                    prompt_len=len(e.request.prompt),
                    reason="deadline", slo=e.slo, replica=e.replica,
                    replays=e.replays, handoffs=e.handoffs,
                    ttft_s=(None if e.t_first is None
                            else e.t_first - e.t_arrive),
                    duration_s=now - e.t_arrive,
                )

    # ----------------------------------------------------------- hedging
    def _spawn_hedges(self) -> None:
        """Arm one duplicate per eligible slow request: the hedge is
        a :func:`resume_request` re-admission (same uid, committed
        stream as prompt suffix) queued on the least-loaded OTHER
        replica.  Safe because both copies draw the SAME stream
        (seeded/greedy determinism + absolute-position key folds);
        :meth:`_absorb` resolves the race first-commit-wins."""
        if not self._has_hedging:
            return
        alive = [r for r in self.replicas if r.alive]
        if len(alive) < 2:
            return
        now = self._clock()
        for e in self.log.entries():
            uid = e.request.uid
            if e.done or uid in self._hedges \
                    or uid in self._hedged_once:
                continue
            cls = self.policy.cls(e.slo)
            if cls.hedge_after_s is None \
                    or now - e.t_arrive < cls.hedge_after_s:
                continue
            # never hedge onto a prefill-role replica: it would ingest
            # the replay and then wait for a handoff the sweep refuses
            # (hedge copies are not log holders) — a slot burned for
            # nothing
            cands = [r for r in alive if r.name != e.replica
                     and r.role != "prefill"]
            if not cands:
                continue
            try:
                req = resume_request(e)
            except ValueError:
                continue                    # no budget left: let the
            target = min(cands, key=self._load)  # completion land
            self._hedged_once.add(uid)
            self._hedges[uid] = {"replica": target.name,
                                 "base": list(e.emitted)}
            self._queues[target.name].append(req)
            self.stats["hedges"] += 1
            self._event("hedge_spawn", uid=uid, replica=target.name,
                        primary=e.replica, base=len(e.emitted))

    def _drop_hedge(self, uid: Any, cause: str) -> None:
        """Cancel a live hedge (queue entry and/or in-flight slot on
        the hedge replica); its harvested tokens are duplicates of a
        committed-or-regenerable prefix, so dropping them loses
        nothing."""
        h = self._hedges.pop(uid, None)
        if h is None:
            return
        q = self._queues.get(h["replica"])
        if q is not None and any(x.uid == uid for x in q):
            self._queues[h["replica"]] = collections.deque(
                x for x in q if x.uid != uid)
        rep = self._by_name.get(h["replica"])
        if rep is not None and rep.alive:
            rep.batcher.cancel(uid)
        self.stats["hedge_losses"] += 1
        self._event("hedge_loss", uid=uid, replica=h["replica"],
                    cause=cause)

    def _drop_hedges_on(self, name: str, cause: str) -> None:
        """A dead replica's hedges just evaporate — the primaries are
        unaffected (hedges never feed the log until they win)."""
        for uid in [u for u, h in self._hedges.items()
                    if h["replica"] == name]:
            self._drop_hedge(uid, cause)

    # ---------------------------------------------------------- brownout
    def _brownout_eval(self) -> None:
        """Walk the ladder: escalate immediately on any rung's
        trigger, de-escalate one rung per step only when the current
        rung's trigger clears by the recover margin (hysteresis).
        Every transition counts in ``brownout_transitions`` and
        re-applies the batcher levers (speculation flag, chunk
        throttle)."""
        bp = self.policy.brownout
        if bp is None:
            return
        alive = [r for r in self.replicas if r.alive]
        if not alive:
            return
        free = min(
            (r.batcher.cache.allocator.num_free
             / max(1, r.batcher.cache.config.num_pages - 1))
            for r in alive)
        qd = sum(len(q) for q in self._queues.values())
        target = 0
        for i in range(3):
            if free <= bp.page_frac[i] or qd >= bp.queue_depth[i]:
                target = i + 1
        lvl = self.brownout_level
        if target > lvl:
            new = target
        elif target < lvl:
            i = lvl - 1
            clear = (free >= min(1.0,
                                 bp.page_frac[i] * bp.recover_margin)
                     and qd <= bp.queue_depth[i] / bp.recover_margin)
            new = lvl - 1 if clear else lvl
        else:
            new = lvl
        if new == lvl:
            return
        self.brownout_level = new
        self.stats["brownout_transitions"] += 1
        self._event("brownout", from_level=lvl, to_level=new,
                    free_page_frac=round(free, 4), queue_depth=qd)
        for r in self.replicas:
            r.batcher.speculation_enabled = new < 1
            r.batcher.chunk_throttle = (bp.chunk_throttle
                                        if new >= 2 else 1)

    # ---------------------------------------------------------- failover
    def _migrate(self, dead: Replica) -> None:
        """Re-admit everything a dead replica held: queued requests
        move as-is, in-flight ones replay their committed tokens as
        prompt suffix (:func:`resume_request`).  Zero requests are
        lost; uncommitted (unharvested) tokens are regenerated, not
        recovered."""
        entries = self.log.inflight_on(dead.name)
        self._queues[dead.name].clear()
        self._event("replica_dead", replica=dead.name,
                    migrated=len(entries))
        for e in entries:
            # a live hedge is dropped BEFORE re-routing the primary:
            # otherwise the migration could land the primary on the
            # hedge's replica — two slots serving one uid
            self._drop_hedge(e.request.uid, "primary_migrated")
            req = resume_request(e)
            target, aff = self._route(req)
            self.log.reassign(req.uid, target.name)
            self._queues[target.name].append(req)
            self.stats["migrations"] += 1
            self.stats["routed"][target.name] += 1
            self._event("request_migrated", uid=req.uid,
                        replica=target.name, replays=e.replays,
                        affinity=aff)

    # ----------------------------------------------------------- journal
    def resume_from_journal(self, recovery) -> Dict[str, int]:
        """Rebuild fleet state from a
        :class:`~apex_tpu_torch.fleet.journal.JournalRecovery` (a restarted
        process's first act, after the checkpoint seam rebuilt the
        weight pools): completed requests land straight in
        ``self.completions`` with their recorded streams; in-flight
        ones re-admit through the migration path — committed tokens
        replayed as prompt suffix, token-identical continuations.
        When the router carries a journal, its cursor is primed so
        only NEW tokens are journaled from here on (reuse ONE journal
        path across restarts).

        Returns ``{"resumed", "completed", "corrupt", "gapped"}``."""
        now = self._clock()
        resumed = completed = 0
        for uid, info in recovery.entries.items():
            if uid in self.log:
                continue
            try:
                slo = self.policy.cls(info["slo"]).name
            except ValueError:
                slo = self.policy.classes[0].name
            e = self.log.admit(info["request"], slo, "<journal>", now)
            e.emitted = list(info["emitted"])
            self._cls[uid] = slo
            if info["done"]:
                e.replayed = list(e.emitted)
                e.done, e.reason, e.t_done = True, info["reason"], now
                self.completions[uid] = FleetCompletion(
                    uid=uid, tokens=list(e.emitted),
                    prompt_len=len(info["request"].prompt),
                    reason=info["reason"], slo=slo,
                    replica="<journal>")
                completed += 1
                continue
            if len(e.emitted) >= info["request"].max_new_tokens:
                # the stream is complete but the terminal record was
                # lost with the process: close it out as budget
                e.replayed = list(e.emitted)
                e.done, e.reason, e.t_done = True, "budget", now
                self.completions[uid] = FleetCompletion(
                    uid=uid, tokens=list(e.emitted),
                    prompt_len=len(info["request"].prompt),
                    reason="budget", slo=slo, replica="<journal>")
                completed += 1
                continue
            if info.get("deadline_s") is not None:
                e.deadline_rel = float(info["deadline_s"])
                e.deadline = now + e.deadline_rel   # re-armed in full
                self._deadlines_live = True
            req = resume_request(e)
            target, aff = self._route(req)
            self.log.reassign(uid, target.name)
            self._queues[target.name].append(req)
            self.stats["routed"][target.name] += 1
            self.stats["resumed_from_journal"] += 1
            resumed += 1
            self._event("request_migrated", uid=uid,
                        replica=target.name, replays=e.replays,
                        affinity=aff, cause="journal")
        if self.journal is not None:
            self.journal.prime(self.log)
        out = {"resumed": resumed, "completed": completed,
               "corrupt": recovery.corrupt, "gapped": recovery.gapped}
        self._event("journal_replayed", **out)
        return out
