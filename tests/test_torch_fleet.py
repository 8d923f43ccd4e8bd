"""The port's fleet tier against the JAX package's, on the CPU: routing,
admission control, failover and the load generator.

The tiny GPT of JAX's fleet bench (vocab 256, 2 layers, hidden 64, 4 heads
of 16, fp32 compute), its leaves redrawn from a numpy seed and converted
to the port, serves through two replicas of each package (pages of 4,
chunks of 8, 2 slots a replica, one ``decode_fns`` shared by the
replicas).  The same trace goes through ``apex_tpu.fleet.FleetRouter`` over
JAX batchers and ``apex_tpu_torch.fleet.FleetRouter`` over the port's, and
what is held equal:

- the replica every request was routed to, ``router.stats`` and the
  rejections with their reasons, under affinity, least-loaded and
  round-robin routing and under admission control;
- every completion's tokens, greedy and seeded-sampled (T 0.9, top-k 20),
  and after the kill drill (r0 dies after a few windows), where they also
  equal the unkilled run's;
- the host pieces alone: :class:`FleetPolicy` / :class:`SLOClass`
  validation, :class:`RequestLog` and :func:`resume_request`, the routing
  key, and ``tools/load_gen.py``'s traces and summaries, which the port's
  copy reproduces for the same arguments and seed.

``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper
(jax 0.9's vma check rejects the JAX serving steps, which is why JAX's own
``tests/test_fleet.py`` fails on this host), and the model-parallel state
is destroyed before and after.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu._compat
from apex_tpu import fleet as jfleet
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import serve as jserve
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch import fleet as tfleet
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serving import kv_cache as tkv
from apex_tpu_torch.serving import serve as tserve
from apex_tpu_torch.tools import load_gen as tload

torch.set_num_threads(1)  # the suite's parallel workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools import load_gen as jload  # noqa: E402

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=4, max_position_embeddings=128)
PAGE, CHUNK, MAXP = 4, 8, 48
PPS = MAXP // PAGE
#: the routing trace: JAX's fleet bench trace shape at this model's scale
#: (4 cohorts of a 16-token system prompt)
TRACE = dict(n_requests=14, mean_gap=0.5, burstiness=6.0,
             prompt_len=(20, 32), new_tokens=(3, 6), interactive_frac=0.5,
             cohorts=4, cohort_frac=0.9, prefix_len=16)
SAMPLED = dict(temperature=0.9, top_k=20)


@pytest.fixture(scope="module")
def sides():
    original = apex_tpu._compat.shard_map

    def shard_map(f, mesh, in_specs, out_specs, check=True):
        return original(f, mesh, in_specs, out_specs, check=False)

    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(apex_tpu._compat, "shard_map", shard_map)
        mesh = parallel_state.initialize_model_parallel(
            devices=jax.devices()[:1])
        jm = JaxGPTModel(JaxGPTConfig(**SIZES, compute_dtype=jnp.float32,
                                      remat=False, attention_impl="xla"))
        rng = np.random.RandomState(3)
        params = jax.tree.map(
            lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32),
            jm.init(jax.random.PRNGKey(0)))
        tm = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                      device="cpu")
        tm.load_state_dict(convert.params_from_jax(params))
        jax_side = types.SimpleNamespace(
            kv=jkv, serve=jserve, fleet=jfleet, load=jload,
            dtype=jnp.float32, pools=jkv.init_pools,
            fns=lambda c, **kw: jm.decode_fns(params, mesh, c,
                                              max_prompt_len=MAXP, **kw),
            cache={}, runs={})
        port_side = types.SimpleNamespace(
            kv=tkv, serve=tserve, fleet=tfleet, load=tload,
            dtype=torch.float32, pools=lambda c: tkv.init_pools(c, "cpu"),
            fns=lambda c, **kw: tm.decode_fns(c, max_prompt_len=MAXP, **kw),
            cache={}, runs={})
        yield jax_side, port_side
    parallel_state.destroy_model_parallel()
    assert apex_tpu._compat.shard_map is original


def _ccfg(side, slots=2, pages=None):
    return side.kv.KVCacheConfig(
        num_layers=2, num_heads=4, head_dim=16,
        num_pages=pages or 1 + 2 * PPS, page_size=PAGE, max_seqs=slots,
        pages_per_seq=PPS, dtype=side.dtype)


def _fns(side, slots=2, pages=None, sampling=None):
    """One ``decode_fns`` a cache shape, shared by every replica."""
    key = (slots, pages, tuple(sorted((sampling or {}).items())))
    if key not in side.cache:
        side.cache[key] = side.fns(_ccfg(side, slots, pages),
                                   prefill_chunk=CHUNK, **(sampling or {}))
    return side.cache[key]


def _replicas(side, n=2, sampling=None):
    fns = _fns(side, sampling=sampling)
    cfg = _ccfg(side)
    return [side.fleet.Replica(f"r{i}", side.serve.ContinuousBatcher(
        fns.prefill, fns.decode, side.kv.PagedKVCache(cfg), side.pools(cfg),
        max_prompt_len=MAXP, harvest_every=2, chunk_fn=fns.chunk,
        prefill_chunk=CHUNK, prefix_cache=True)) for i in range(n)]


def _trace(side, seed, **kw):
    return side.load.make_trace(seed=seed, vocab_size=256,
                                **dict(TRACE, **kw))


def _tokens(router):
    return {u: c.tokens for u, c in sorted(router.completions.items())}


def _holders(router):
    return {e.request.uid: e.replica for e in router.log.entries()}


def _replay(side, routing="affinity", sampling=None, fail_after=None):
    """Trace 11 through a fresh 2-replica fleet, once a module for each
    (routing, sampling, kill) combination: the routing and kill tests
    share their references."""
    key = (routing, tuple(sorted((sampling or {}).items())), fail_after)
    if key not in side.runs:
        router = side.fleet.FleetRouter(
            _replicas(side, sampling=sampling),
            side.fleet.FleetPolicy(routing=routing))
        if fail_after is not None:
            router.replicas[0].fail_after(fail_after)
        side.runs[key] = router, side.load.replay(router, _trace(side, 11))
    return side.runs[key]


# ---------------------------------------------------------------------------
# host pieces: no model
# ---------------------------------------------------------------------------


BAD_POLICIES = [
    ("routing", dict(routing="hash_ring")),
    ("duplicate", dict(classes="dup")),
    ("step_floor_s", dict(step_floor_s=-1)),
    ("pump_timeout_s", dict(pump_timeout_s=0)),
    ("max_replica_faults", dict(max_replica_faults=0)),
    ("roles", dict(roles=("prefill", "verify"))),
    ("decode", dict(roles=("prefill", "prefill"))),
    ("prefill", dict(roles=("decode", "decode"))),
]


@pytest.mark.parametrize("what, kw", BAD_POLICIES,
                         ids=[w for w, _ in BAD_POLICIES])
def test_policy_validation_matches_jax(sides, what, kw):
    msgs = []
    for side in sides:
        f = side.fleet
        args = (dict(classes=(f.INTERACTIVE, f.SLOClass("interactive")))
                if kw.get("classes") == "dup" else kw)
        with pytest.raises(ValueError, match=what) as err:
            f.FleetPolicy(**args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


BAD_CLASSES = [("name", dict(name="")), ("max_queue", dict(max_queue=0)),
               ("deadline_s", dict(deadline_s=0)),
               ("max_retries", dict(max_retries=-1)),
               ("hedge_after_s", dict(hedge_after_s=0))]


@pytest.mark.parametrize("what, kw", BAD_CLASSES,
                         ids=[w for w, _ in BAD_CLASSES])
def test_slo_class_validation_matches_jax(sides, what, kw):
    msgs = []
    for side in sides:
        with pytest.raises(ValueError, match=what) as err:
            side.fleet.SLOClass(**dict(dict(name="x"), **kw))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_policy_defaults_match_jax(sides):
    j, t = (s.fleet.FleetPolicy() for s in sides)
    assert t.routing == j.routing == "affinity"
    assert [dataclass_tuple(c) for c in t.classes] == \
        [dataclass_tuple(c) for c in j.classes]
    assert t.cls("interactive").priority < t.cls("batch").priority
    with pytest.raises(ValueError, match="unknown SLO class"):
        t.cls("premium")


def dataclass_tuple(c):
    return (c.name, c.priority, c.max_queue, c.deadline_s, c.max_retries,
            c.hedge_after_s)


def _log_state(e):
    return (list(e.emitted), list(e.replayed), e.replica, e.replays,
            e.done, e.reason, e.t_first, e.t_done, e.handoffs)


def test_request_log_and_resume_match_jax(sides):
    """One sequence of log operations on both packages' logs: the same
    entries, the same resume requests, the same errors."""
    out = []
    for side in sides:
        log = side.fleet.RequestLog()
        R = side.serve.Request
        a = log.admit(R(uid="a", prompt=[1, 2, 3, 4], max_new_tokens=8,
                        seed=7), slo="interactive", replica="r0",
                      t_arrive=10.0)
        log.admit(R(uid="b", prompt=[5, 6], max_new_tokens=2, seed=None),
                  slo="batch", replica="r0", t_arrive=10.5)
        with pytest.raises(ValueError, match="already logged"):
            log.admit(R(uid="a", prompt=[1], max_new_tokens=1),
                      slo="interactive", replica="r0", t_arrive=11.0)
        log.record_progress("r1", {"a": [5, 6]}, now=11.0)  # not holder
        log.record_progress("r0", {"a": [9, 9, 8], "b": [3, 4]}, now=12.0)
        with pytest.raises(ValueError, match="no budget"):
            side.fleet.resume_request(log.get("b"))
        with pytest.raises(ValueError, match="over-committed"):
            log.record_progress("r0", {"b": [3, 4, 5]}, now=12.5)
        log.complete("b", [3, 4], "budget", now=13.0)
        r = side.fleet.resume_request(a)
        log.reassign("a", "r1")
        log.record_progress("r1", {"a": [7]}, now=14.0)
        log.handoff("a", "r2")
        out.append((
            {u: _log_state(log.get(u)) for u in ("a", "b")},
            (r.uid, list(r.prompt), r.max_new_tokens, r.seed),
            [e.request.uid for e in log.inflight_on("r2")],
            log.pending(), len(log)))
    assert out[0] == out[1]
    assert out[1][1] == ("a", [1, 2, 3, 4, 9, 9, 8], 5, 7)


def test_routing_key_and_match_len_match_jax(sides):
    rng = np.random.RandomState(9)
    prompt = [int(t) for t in rng.randint(1, 256, (23,))]
    keys = [side.kv.prompt_page_hashes(prompt, PAGE) for side in sides]
    assert keys[0] == keys[1] and len(keys[1]) == 5
    assert tkv.prompt_page_hashes(prompt[:3], PAGE) == []
    cache = tkv.PagedKVCache(_ccfg(sides[1]))
    free = cache.allocator.num_free
    assert cache.match_len(keys[1]) == 0 and cache.allocator.num_free == free


TRACES = [
    ("flagship-routing-11", "make_trace",
     dict(n_requests=64, seed=11, vocab_size=32768, mean_gap=0.5,
          burstiness=6.0, prompt_len=(544, 704), new_tokens=(16, 32),
          interactive_frac=0.5, cohorts=4, cohort_frac=0.9,
          prefix_len=512)),
    ("flagship-routing-6", "make_trace",
     dict(n_requests=64, seed=6, vocab_size=32768, mean_gap=0.5,
          burstiness=6.0, prompt_len=(544, 704), new_tokens=(16, 32),
          interactive_frac=0.5, cohorts=4, cohort_frac=0.9,
          prefix_len=512)),
    ("flagship-mixed-21", "make_mixed_trace",
     dict(n_requests=48, seed=21, vocab_size=32768, mean_gap=2.0,
          burstiness=6.0, long_frac=0.6, short_prompt=(64, 128),
          long_prompt=(320, 512), new_tokens=(16, 28), session_frac=0.25,
          idle_gap=16.0)),
    ("defaults", "make_trace", dict(n_requests=32, seed=4, vocab_size=64)),
    ("mixed-defaults", "make_mixed_trace",
     dict(n_requests=32, seed=5, vocab_size=64)),
]


@pytest.mark.parametrize("fn, kw", [(f, k) for _, f, k in TRACES],
                         ids=[n for n, _, _ in TRACES])
def test_load_gen_traces_match_jax(sides, fn, kw):
    def shape(trace):
        return [(it.t, it.slo, it.cohort, it.request.uid,
                 list(it.request.prompt), it.request.max_new_tokens,
                 it.request.seed) for it in trace]

    j, t = (getattr(side.load, fn)(**kw) for side in sides)
    assert shape(t) == shape(j)
    assert all(isinstance(it.request, tserve.Request) for it in t)


def test_load_gen_validation_and_summary_match_jax(sides):
    for side in sides:
        with pytest.raises(ValueError, match="prefix_len"):
            side.load.make_trace(n_requests=1, seed=0, vocab_size=64,
                                 prefix_len=48, prompt_len=(8, 48))
        with pytest.raises(ValueError, match="burstiness"):
            side.load.make_trace(n_requests=1, seed=0, vocab_size=64,
                                 burstiness=0.5)
    records = [
        {"uid": "a", "slo": "interactive", "reason": "budget",
         "ttft_s": 0.1, "itl_ms": 2.0, "replays": 1},
        {"uid": "b", "slo": "batch", "reason": "budget", "ttft_s": 0.4,
         "itl_ms": 3.0, "handoffs": 1},
        {"uid": "c", "slo": "interactive", "rejected": "too_large"},
        {"uid": "d", "slo": "batch", "lost": True},
        {"uid": "e", "slo": "interactive", "reason": "deadline",
         "ttft_s": 0.2, "hedged": True},
    ]
    j, t = (side.load.summarize_trace(records) for side in sides)
    assert t == j
    assert (t["requests"], t["completed"], t["rejected"], t["lost"],
            t["migrated"], t["handed_off"]) == (5, 3, 1, 1, 1, 1)


# ---------------------------------------------------------------------------
# the router over the tiny GPT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routing", ["affinity", "least_loaded",
                                     "round_robin"])
def test_routing_matches_jax(sides, routing):
    """One trace, the same decisions: the replica each request went to,
    every stat (affinity hits included) and every stream."""
    runs = [_replay(side, routing) for side in sides]
    (jr, jrecs), (tr, trecs) = runs
    assert _holders(tr) == _holders(jr)
    assert tr.stats == jr.stats
    assert _tokens(tr) == _tokens(jr)
    assert len(tr.completions) == TRACE["n_requests"]
    strip = lambda recs: [{k: v for k, v in r.items()    # noqa: E731
                           if k not in ("ttft_s", "itl_ms")} for r in recs]
    assert strip(trecs) == strip(jrecs)
    if routing == "affinity":
        assert tr.stats["affinity_routed"] > 0
    else:
        assert tr.stats["affinity_routed"] == 0
    chunks = [sum(r.batcher.prefill_chunks for r in x.replicas)
              for x in (jr, tr)]
    hits = [sum(r.batcher.prefix_stats["hits"] for r in x.replicas)
            for x in (jr, tr)]
    assert chunks[0] == chunks[1] and hits[0] == hits[1]


def test_admission_control_matches_jax(sides):
    """Rejections and their reasons: replay headroom, the pool's size and
    a full class queue; a lower class still admits."""
    out = []
    for side in sides:
        f, R = side.fleet, side.serve.Request
        policy = f.FleetPolicy(classes=(
            f.SLOClass("interactive", 0, max_queue=1),
            f.SLOClass("batch", 1)))
        router = f.FleetRouter(_replicas(side), policy)
        got = [router.submit(R(uid="big", prompt=[1] * 40,
                               max_new_tokens=10)),
               router.submit(R(uid="a", prompt=[1, 2, 3],
                               max_new_tokens=4)),
               router.submit(R(uid="b", prompt=[1, 2, 4],
                               max_new_tokens=4)),
               router.submit(R(uid="c", prompt=[1, 2, 5],
                               max_new_tokens=4), "batch")]
        pending = router.pending
        order = [r.uid for r in router._pump_order("r0")]
        router.drain()
        out.append((got, dict(router.rejected), pending, order,
                    router.stats, _tokens(router)))
    assert out[0] == out[1]
    assert out[1][:3] == ([False, True, False, True],
                          {"big": "too_large", "b": "queue_full"}, 2)


def test_pump_order_matches_jax(sides):
    orders = []
    for side in sides:
        R = side.serve.Request
        router = side.fleet.FleetRouter(_replicas(side, n=1))
        for uid, slo in (("b1", "batch"), ("i1", "interactive"),
                         ("b2", "batch"), ("i2", "interactive")):
            router.submit(R(uid=uid, prompt=[1, len(uid), ord(uid[1])],
                            max_new_tokens=2), slo)
        orders.append([r.uid for r in router._pump_order("r0")])
        router.drain()
        orders.append(sorted(router.completions))
    assert orders[0] == orders[2] == ["i1", "i2", "b1", "b2"]
    assert orders[1] == orders[3]


@pytest.mark.parametrize("sampling", [None, SAMPLED],
                         ids=["greedy", "seeded-sampled"])
def test_kill_drill_matches_jax(sides, sampling):
    """r0 dies with work queued and in flight: every request completes,
    some migrate, the streams are the unkilled run's, and the port's
    router does what JAX's does."""
    out = []
    for side in sides:
        ref, _ = _replay(side, sampling=sampling)
        drill, recs = _replay(side, sampling=sampling, fail_after=3)
        assert not drill.replicas[0].alive
        assert drill.stats["migrations"] >= 1
        assert _tokens(drill) == _tokens(ref)
        assert any(c.replays > 0 for c in drill.completions.values())
        assert side.load.summarize_trace(recs)["lost"] == 0
        out.append((_tokens(drill), drill.stats, _holders(drill),
                    {u: c.replays for u, c in drill.completions.items()}))
    assert out[0] == out[1]
    if sampling is not None:
        greedy, _ = _replay(sides[1])
        assert out[1][0] != _tokens(greedy)


def test_dead_fleet_raises_not_hangs(sides):
    side = sides[1]
    router = side.fleet.FleetRouter(_replicas(side))
    router.submit(side.serve.Request(uid="a", prompt=[1, 2, 3],
                                     max_new_tokens=4))
    for r in router.replicas:
        r.kill()
    with pytest.raises(RuntimeError, match="no replica is alive"):
        router.drain()


def test_replicas_must_share_page_size(sides):
    side = sides[1]
    fns = _fns(side)
    other = tkv.KVCacheConfig(num_layers=2, num_heads=4, head_dim=16,
                              num_pages=17, page_size=8, max_seqs=2,
                              pages_per_seq=4, dtype=torch.float32)
    reps = _replicas(side, n=1) + [tfleet.Replica(
        "odd", tserve.ContinuousBatcher(
            fns.prefill, fns.decode, tkv.PagedKVCache(other),
            tkv.init_pools(other, "cpu"), max_prompt_len=MAXP))]
    with pytest.raises(ValueError, match="page_size"):
        tfleet.FleetRouter(reps)


#: fields that are wall times, left out where records are compared
TIMES = ("t", "dur_s", "dispatch_s", "draft_s", "ttft_s", "duration_s",
         "itl_ms")


class Capture:
    """A logger that records the events and gauges it is handed (wall
    times left out) and a watchdog that records its beats."""

    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append(("event", kind, {
            k: v for k, v in fields.items() if k not in TIMES}))

    def gauge(self, name, value):
        self.records.append(("gauge", name, value))

    def beat(self, step=None, extra=None):
        self.records.append(("beat", step, dict(extra or {})))


def _logged_replay(side, arg):
    """Trace 11 through a 2-replica fleet whose router (and, for the
    logger, every batcher) reports to a :class:`Capture`; r0 dies after
    3 windows, so failover's events are in the stream."""
    cap = Capture()
    reps = _replicas(side)
    if arg == "logger":
        for r in reps:
            r.batcher.logger = cap
    router = side.fleet.FleetRouter(reps, side.fleet.FleetPolicy(),
                                    **{arg: cap})
    router.replicas[0].fail_after(3)
    side.load.replay(router, _trace(side, 11))
    return cap.records, _tokens(router)


@pytest.mark.parametrize("arg", ["logger", "watchdog"])
def test_router_logger_and_watchdog_match_jax(sides, arg):
    """The router's ``logger=`` gets JAX's records (the router's events,
    every batcher's events and gauges, the replay's ``trace_request``
    records) in JAX's order, and ``watchdog=`` JAX's beats (one before
    every pump, with the replica's serving fields), over a kill drill;
    the tokens are the unlogged run's."""
    (jrec, jtok), (trec, ttok) = (_logged_replay(s, arg) for s in sides)
    kinds = {r[1] for r in trec}
    if arg == "logger":
        assert {"request_routed", "replica_dead", "request_migrated",
                "request_admitted", "span", "request_done",
                "trace_request", "pages_free", "queue_depth"} <= kinds
    else:
        assert {r[0] for r in trec} == {"beat"} and len(trec) > 10
    assert trec == jrec
    assert ttok == jtok == _tokens(_replay(sides[1], fail_after=3)[0])
