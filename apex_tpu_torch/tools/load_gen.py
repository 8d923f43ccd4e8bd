"""load_gen: deterministic trace-replay load generator for the fleet.

The port's copy of the repo's ``tools/load_gen.py``, building the port's
:class:`~apex_tpu_torch.serving.serve.Request`: the same arguments and
seed give the same trace (arrival times, prompts, budgets, seeds, classes,
cohorts) as the JAX package's tool.  A router's p99 is made by its worst
moments, and the traces make them reproducibly:

- **bursty arrivals** from one seeded stream: a two-state modulated
  process whose exponential gaps shrink by ``burstiness`` inside a burst
  and stretch by it between bursts (mean rate ``1/mean_gap`` either way);
- **ragged lengths**: prompt and output lengths drawn uniformly from
  ranges;
- **mixed SLO classes**: interactive with probability
  ``interactive_frac``, else batch;
- **shared-prefix cohorts**: ``cohort_frac`` of requests open with one of
  ``cohorts`` fixed system prompts (what prefix-affinity routing is for).

Every request carries a derived ``seed``, so a trace replayed through any
fleet shape gives the same token streams, which is what lets a kill drill
compare a killed run with an unkilled one token for token.
:func:`replay` drives a :class:`~apex_tpu_torch.fleet.router.FleetRouter`
in logical time (arrivals release as fleet steps advance) while TTFT and
ITL are wall seconds, and with a router ``logger`` each record also lands
as a ``trace_request`` event; :func:`summarize_trace` scores the records.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.serving.serve import Request

__all__ = ["TraceItem", "make_trace", "make_mixed_trace", "replay",
           "summarize_trace"]


@dataclasses.dataclass
class TraceItem:
    """One arrival: ``t`` is abstract trace time (logical units)."""

    t: float
    request: Request
    slo: str
    cohort: Optional[int]       # None = cold one-off prompt


def make_trace(
    *,
    n_requests: int,
    seed: int,
    vocab_size: int,
    mean_gap: float = 1.0,
    burstiness: float = 4.0,
    prompt_len: Tuple[int, int] = (8, 48),
    new_tokens: Tuple[int, int] = (4, 16),
    interactive_frac: float = 0.7,
    cohorts: int = 4,
    cohort_frac: float = 0.8,
    prefix_len: int = 24,
    burst_len: float = 8.0,
) -> List[TraceItem]:
    """Build a deterministic trace (same args + seed -> byte-identical
    requests and arrival times).  Token ids are drawn from
    ``[1, vocab_size)`` — id 0 is left out so traces compose with
    servers that pad with 0.  ``prompt_len`` bounds INCLUDE the cohort
    prefix; ``prefix_len`` must leave room for at least one suffix
    token below the upper bound."""
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if not (0.0 <= cohort_frac <= 1.0 and
            0.0 <= interactive_frac <= 1.0):
        raise ValueError("fractions must be in [0, 1]")
    if cohorts > 0 and prefix_len >= prompt_len[1]:
        raise ValueError(
            f"prefix_len {prefix_len} leaves no room for a suffix "
            f"below the prompt_len bound {prompt_len[1]}")
    if burstiness < 1.0:
        raise ValueError("burstiness must be >= 1 (1 = plain Poisson)")
    rng = np.random.RandomState(seed)
    prefixes = [
        [int(t) for t in rng.randint(1, vocab_size, (prefix_len,))]
        for _ in range(cohorts)
    ]
    items: List[TraceItem] = []
    t, in_burst, phase_left = 0.0, True, burst_len
    for i in range(n_requests):
        # two-state modulated arrivals: tight gaps inside a burst,
        # stretched gaps in the lull, same 1/mean_gap long-run rate
        scale = (mean_gap / burstiness if in_burst
                 else mean_gap * burstiness)
        gap = float(rng.exponential(scale))
        t += gap
        phase_left -= 1.0
        if phase_left <= 0:
            in_burst = not in_burst
            phase_left = float(rng.exponential(burst_len)) + 1.0
        cohort: Optional[int] = None
        if cohorts > 0 and rng.rand() < cohort_frac:
            cohort = int(rng.randint(cohorts))
            lo = max(prompt_len[0], prefix_len + 1)
            plen = int(rng.randint(lo, prompt_len[1] + 1))
            prompt = prefixes[cohort] + [
                int(x) for x in
                rng.randint(1, vocab_size, (plen - prefix_len,))]
        else:
            plen = int(rng.randint(prompt_len[0], prompt_len[1] + 1))
            prompt = [int(x) for x in
                      rng.randint(1, vocab_size, (plen,))]
        slo = ("interactive" if rng.rand() < interactive_frac
               else "batch")
        items.append(TraceItem(
            t=t,
            request=Request(
                uid=f"t{i:04d}", prompt=prompt,
                max_new_tokens=int(rng.randint(new_tokens[0],
                                               new_tokens[1] + 1)),
                seed=int(rng.randint(1, 2**31 - 1))),
            slo=slo, cohort=cohort))
    return items


def make_mixed_trace(
    *,
    n_requests: int,
    seed: int,
    vocab_size: int,
    mean_gap: float = 1.0,
    burstiness: float = 4.0,
    long_frac: float = 0.5,
    short_prompt: Tuple[int, int] = (4, 10),
    long_prompt: Tuple[int, int] = (24, 44),
    new_tokens: Tuple[int, int] = (3, 6),
    interactive_frac: float = 0.8,
    session_frac: float = 0.3,
    idle_gap: float = 20.0,
    resume_suffix: Tuple[int, int] = (2, 6),
    burst_len: float = 8.0,
) -> List[TraceItem]:
    """The disaggregation workload: long-prompt/short-decode requests
    whose prompt lengths are BIMODAL (``long_frac`` drawn from
    ``long_prompt``, the rest from ``short_prompt``) with tight decode
    budgets — prefill work dominates, which is exactly the regime where
    prefill/decode role separation pays (a long chunked prefill on a
    unified replica stalls every co-resident decode stream's ITL).

    ``session_frac`` of requests are SESSIONS: after an ``idle_gap``
    the same "user" returns with the original prompt plus a short
    suffix (the follow-up turn).  By then the eviction churn of the
    intervening traffic has typically pushed the session's prefix pages
    out of the device index — the idle-then-resume arrival is the host
    offload tier's exerciser (fault-in vs recompute), and without an
    offload tier it measures the recompute cost the tier removes.

    Same determinism contract as :func:`make_trace`: one seeded stream,
    every request carries a derived seed, arrivals sorted by time."""
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    for name, frac in (("long_frac", long_frac),
                       ("interactive_frac", interactive_frac),
                       ("session_frac", session_frac)):
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"{name} must be in [0, 1]")
    if burstiness < 1.0:
        raise ValueError("burstiness must be >= 1 (1 = plain Poisson)")
    rng = np.random.RandomState(seed)
    items: List[TraceItem] = []
    t, in_burst, phase_left = 0.0, True, burst_len
    for i in range(n_requests):
        scale = (mean_gap / burstiness if in_burst
                 else mean_gap * burstiness)
        t += float(rng.exponential(scale))
        phase_left -= 1.0
        if phase_left <= 0:
            in_burst = not in_burst
            phase_left = float(rng.exponential(burst_len)) + 1.0
        lo, hi = (long_prompt if rng.rand() < long_frac
                  else short_prompt)
        prompt = [int(x) for x in
                  rng.randint(1, vocab_size, (int(rng.randint(lo, hi + 1)),))]
        slo = ("interactive" if rng.rand() < interactive_frac
               else "batch")
        budget = int(rng.randint(new_tokens[0], new_tokens[1] + 1))
        items.append(TraceItem(
            t=t,
            request=Request(uid=f"m{i:04d}", prompt=prompt,
                            max_new_tokens=budget,
                            seed=int(rng.randint(1, 2**31 - 1))),
            slo=slo, cohort=None))
        if rng.rand() < session_frac:
            # the follow-up turn: original prompt + a short suffix,
            # arriving after the session went idle — its prefix is the
            # offload tier's fault-in target
            sfx = [int(x) for x in rng.randint(
                1, vocab_size,
                (int(rng.randint(resume_suffix[0],
                                 resume_suffix[1] + 1)),))]
            items.append(TraceItem(
                t=t + idle_gap + float(rng.exponential(mean_gap)),
                request=Request(
                    uid=f"m{i:04d}s", prompt=prompt + sfx,
                    max_new_tokens=int(rng.randint(new_tokens[0],
                                                   new_tokens[1] + 1)),
                    seed=int(rng.randint(1, 2**31 - 1))),
                slo=slo, cohort=i))
    items.sort(key=lambda it: (it.t, it.request.uid))
    return items


def replay(
    router,
    trace: List[TraceItem],
    *,
    arrivals_per_step: float = 1.0,
    max_steps: int = 100_000,
) -> List[Dict[str, Any]]:
    """Replay ``trace`` through a fleet router in logical time: each
    :meth:`FleetRouter.step` advances the trace clock by
    ``arrivals_per_step`` units and releases every arrival that is
    due — deterministic scheduling, wall-clock latency measurement.
    Returns one record per request (rejections included) and, when the
    router has a logger, emits a ``trace_request`` event per record."""
    sim, i, steps = 0.0, 0, 0
    n = len(trace)
    while i < n or router.pending > 0:
        while i < n and trace[i].t <= sim:
            it = trace[i]
            router.submit(it.request, it.slo)
            i += 1
        if i < n and router.pending == 0:
            # idle lull: jump to the next arrival instead of spinning
            # empty steps (the jump lands the arrival, so no livelock)
            sim = max(sim, trace[i].t)
            continue
        router.step()
        steps += 1
        sim += arrivals_per_step
        if steps >= max_steps:
            raise RuntimeError(
                f"trace did not drain in {max_steps} fleet steps "
                f"({router.pending} pending)")
    records: List[Dict[str, Any]] = []
    by_uid = {it.request.uid: it for it in trace}
    for uid, it in by_uid.items():
        if uid in router.rejected:
            rec = {"uid": uid, "slo": it.slo, "cohort": it.cohort,
                   "rejected": router.rejected[uid]}
        elif uid in router.completions:
            c = router.completions[uid]
            rec = {
                "uid": uid, "slo": c.slo, "cohort": it.cohort,
                "replica": c.replica, "replays": c.replays,
                "new_tokens": len(c.tokens), "reason": c.reason,
                "ttft_s": (None if c.ttft_s is None
                           else round(c.ttft_s, 6)),
                "itl_ms": (None if c.itl_ms is None
                           else round(c.itl_ms, 3)),
            }
            if getattr(c, "hedged", False):
                rec["hedged"] = True
            if getattr(c, "handoffs", 0):
                rec["handoffs"] = c.handoffs
        else:            # unreachable when drain finished
            rec = {"uid": uid, "slo": it.slo, "cohort": it.cohort,
                   "lost": True}
        records.append(rec)
        if router.logger is not None:
            router.logger.event("trace_request", **rec)
    return records


def _pct(xs: List[float], q: float) -> float:
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


def summarize_trace(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Score a replay: per-class and overall TTFT/ITL percentiles,
    plus the loss/rejection/migration ledger the zero-loss drill
    asserts over."""
    out: Dict[str, Any] = {
        "requests": len(records),
        "rejected": sum(1 for r in records if "rejected" in r),
        "lost": sum(1 for r in records if r.get("lost")),
        "migrated": sum(1 for r in records
                        if r.get("replays", 0) > 0),
        # fault-tier ledger: requests cut off at their deadline (a
        # per-request terminal, not a loss) and hedge-resolved streams
        "deadline_missed": sum(1 for r in records
                               if r.get("reason") == "deadline"),
        "hedged": sum(1 for r in records if r.get("hedged")),
        # disaggregation ledger: streams whose ownership moved by PAGE
        # handoff (prefill -> decode) rather than replay
        "handed_off": sum(1 for r in records
                          if r.get("handoffs", 0) > 0),
    }
    done = [r for r in records if "reason" in r]
    out["completed"] = len(done)

    def score(rs: List[Dict[str, Any]]) -> Dict[str, Any]:
        ttfts = [r["ttft_s"] for r in rs
                 if isinstance(r.get("ttft_s"), (int, float))]
        itls = [r["itl_ms"] for r in rs
                if isinstance(r.get("itl_ms"), (int, float))]
        s: Dict[str, Any] = {"n": len(rs)}
        if ttfts:
            s["ttft_s"] = {
                "p50": round(_pct(ttfts, 50), 6),
                "p95": round(_pct(ttfts, 95), 6),
                "p99": round(_pct(ttfts, 99), 6),
                "mean": round(sum(ttfts) / len(ttfts), 6),
            }
        if itls:
            s["itl_ms"] = {"p50": round(_pct(itls, 50), 3),
                           "p99": round(_pct(itls, 99), 3)}
        return s

    out["overall"] = score(done)
    out["by_class"] = {
        name: score([r for r in done if r.get("slo") == name])
        for name in sorted({r.get("slo") for r in done} - {None})
    }
    return out
