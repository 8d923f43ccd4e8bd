"""The port's fleet under injected faults against the JAX package's fleet
under the same faults, on the CPU.

The tiny GPT of ``tests/test_torch_fleet.py`` (vocab 256, 2 layers, hidden
64, fp32), two replicas of each package, the same requests and the same
fault schedule from each package's own ``resilience.faults`` (the port's
copy patches the port's seams: ``serve._device_get``, a batcher's window
and steps, its allocator).  Held equal to JAX's router:

- health: repeated non-finite logits quarantine the replica (its faults,
  its last error's type), one failed window heals, a stalled pump and a
  hanging harvest past ``pump_timeout_s`` quarantine; the work migrates
  and every stream equals the unfaulted run's;
- deadlines on an injected clock: an unmeetable one rejected at
  admission, misses that retry (token-identical) and misses that end the
  request with a committed prefix of its stream;
- hedging on an injected clock: a hedge that wins over a stuck primary
  and hedges that lose when the primary lands, slots and pages released;
- the brownout ladder: its level after every step, the shed class, the
  page-pressure rung (``faults.exhaust_pool``) and the way back down, and
  no token changed.

Beside them, port-only: ``cancel`` mid speculation window (the survivors'
streams untouched, the pages back) and the fault helpers' checkpoint
seams raising until checkpointing is ported.  ``apex_tpu._compat.
shard_map`` is swapped for a ``check=False`` wrapper, as in
``tests/test_torch_fleet.py``.
"""

import collections
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
from apex_tpu.resilience import faults as jfaults
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import serve as jserve
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch import fleet as tfleet
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.resilience import faults as tfaults
from apex_tpu_torch.serving import NGramDraftSource
from apex_tpu_torch.serving import kv_cache as tkv
from apex_tpu_torch.serving import serve as tserve

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=4, max_position_embeddings=128)
PAGE, CHUNK, MAXP = 4, 8, 48
PPS = MAXP // PAGE
#: a pump slower than this is a stall; the faults' sleeps advance the
#: router's injected clock instead of the wall (a loaded host cannot fake
#: a stall, and none costs a real second)
PUMP_TIMEOUT = 1.0


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
        jcfg = jkv.KVCacheConfig(num_layers=2, num_heads=4, head_dim=16,
                                 num_pages=1 + 2 * PPS, page_size=PAGE,
                                 max_seqs=2, pages_per_seq=PPS,
                                 dtype=jnp.float32)
        tcfg = tkv.KVCacheConfig(num_layers=2, num_heads=4, head_dim=16,
                                 num_pages=1 + 2 * PPS, page_size=PAGE,
                                 max_seqs=2, pages_per_seq=PPS,
                                 dtype=torch.float32)
        jax_side = types.SimpleNamespace(
            model=lambda c, **kw: jm.decode_fns(params, mesh, c, **kw),
            kv=jkv, serve=jserve, fleet=jfleet, faults=jfaults, cfg=jcfg,
            pools=lambda: jkv.init_pools(jcfg),
            fns=jm.decode_fns(params, mesh, jcfg, max_prompt_len=MAXP,
                              prefill_chunk=CHUNK), runs={})
        port_side = types.SimpleNamespace(
            kv=tkv, serve=tserve, fleet=tfleet, faults=tfaults, cfg=tcfg,
            pools=lambda: tkv.init_pools(tcfg, "cpu"),
            fns=tm.decode_fns(tcfg, max_prompt_len=MAXP,
                              prefill_chunk=CHUNK), model=tm, runs={},
            decode_fns=tm.decode_fns)
        yield jax_side, port_side
    parallel_state.destroy_model_parallel()
    assert apex_tpu._compat.shard_map is original


def _replicas(side, n=2):
    f = side.fns
    return [side.fleet.Replica(f"r{i}", side.serve.ContinuousBatcher(
        f.prefill, f.decode, side.kv.PagedKVCache(side.cfg), side.pools(),
        max_prompt_len=MAXP, harvest_every=2, chunk_fn=f.chunk,
        prefill_chunk=CHUNK, prefix_cache=True)) for i in range(n)]


def _reqs(side, n=6, new=5, seed0=None, rng_seed=31):
    rng = np.random.RandomState(rng_seed)
    return [side.serve.Request(
        uid=f"u{i}", prompt=[int(t) for t in
                             rng.randint(1, 256, (9 + (i % 3) * 5,))],
        max_new_tokens=new, seed=None if seed0 is None else seed0 + i)
        for i in range(n)]


def _tokens(router):
    return {u: c.tokens for u, c in sorted(router.completions.items())}


def _reference(side, reqs):
    """The unfaulted fleet's streams for ``reqs``, once a module."""
    key = tuple((r.uid, tuple(r.prompt), r.max_new_tokens, r.seed)
                for r in reqs)
    if key not in side.runs:
        router = side.fleet.FleetRouter(_replicas(side))
        for r in reqs:
            assert router.submit(r)
        router.drain()
        side.runs[key] = _tokens(router)
    return side.runs[key]


def _health(r):
    return (r.alive, r.quarantined, r.faults, r.consecutive_faults,
            None if r.last_error is None else r.last_error.split("(")[0],
            r.windows)


# ---------------------------------------------------------------------------
# health monitoring
# ---------------------------------------------------------------------------


HEALTH = ["nonfinite", "transient", "stall", "hanging-harvest"]


@pytest.mark.parametrize("fault", HEALTH)
def test_health_matches_jax(sides, fault, monkeypatch):
    """The same fault on r0 of both fleets: the same quarantine (or
    healing), the same stats, every stream the unfaulted run's."""
    out = []
    for side in sides:
        clk = [0.0]
        monkeypatch.setattr(side.faults, "time", types.SimpleNamespace(
            sleep=lambda s: clk.__setitem__(0, clk[0] + s)))
        f, F = side.fleet, side.faults
        reqs = _reqs(side)
        ref = _reference(side, reqs)
        policy = dict(nonfinite=f.FleetPolicy(max_replica_faults=2),
                      transient=f.FleetPolicy(max_replica_faults=3),
                      stall=f.FleetPolicy(pump_timeout_s=PUMP_TIMEOUT),
                      **{"hanging-harvest": f.FleetPolicy(
                          pump_timeout_s=PUMP_TIMEOUT)})[fault]
        router = f.FleetRouter(_replicas(side), policy,
                               clock=lambda: clk[0])
        for r in reqs:
            assert router.submit(r)
        r0 = router.replicas[0]
        ctx = {"nonfinite": lambda: F.nonfinite_logits(r0.batcher, nth=2,
                                                       forever=True),
               "transient": lambda: F.failing_windows(r0.batcher, nth=1,
                                                      count=1),
               "stall": lambda: F.stalled_pump(r0.batcher,
                                               stall_s=2 * PUMP_TIMEOUT),
               "hanging-harvest": lambda: F.hanging_harvests(
                   nth=3, hang_s=2 * PUMP_TIMEOUT)}[fault]
        with ctx() as seen:
            router.drain()
        assert _tokens(router) == ref
        out.append(([_health(r) for r in router.replicas], router.stats,
                    _tokens(router), seen[0]))
    assert out[0] == out[1]
    health = out[1][0][0]
    if fault == "transient":
        assert health[:4] == (True, None, 1, 0)
    else:
        quarantined = [h for h in out[1][0] if h[1] is not None]
        assert len(quarantined) == 1
        assert quarantined[0][1] == ("faults" if fault == "nonfinite"
                                     else "stall")
    if fault == "nonfinite":
        assert health[4] == "FloatingPointError"


# ---------------------------------------------------------------------------
# deadlines and hedging on an injected clock
# ---------------------------------------------------------------------------


def _clocked(side, policy, reqs, limit, fault=None):
    clk = [0.0]
    router = side.fleet.FleetRouter(_replicas(side), policy,
                                     clock=lambda: clk[0])
    for r in reqs:
        assert router.submit(r)
    ctx = fault(router) if fault else None
    if ctx is not None:
        ctx.__enter__()
    try:
        while router.pending:
            router.step()
            clk[0] += 1.0
            assert clk[0] < limit, "the clocked fleet livelocked"
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return router


DEADLINES = ["retry", "terminal"]


@pytest.mark.parametrize("mode", DEADLINES)
def test_deadlines_match_jax(sides, mode):
    out = []
    for side in sides:
        f = side.fleet
        reqs = _reqs(side, n=6, new=6)
        ref = _reference(side, reqs)
        cls = (f.SLOClass("interactive", 0, deadline_s=2.0, max_retries=50)
               if mode == "retry" else
               f.SLOClass("interactive", 0, deadline_s=3.0, max_retries=0))
        router = _clocked(side, f.FleetPolicy(
            classes=(cls, f.SLOClass("batch", 1))), reqs, 300)
        assert router.stats["deadline_misses"] >= 1
        for uid, c in router.completions.items():
            assert c.tokens == ref[uid][:len(c.tokens)], uid
            if c.reason != "deadline":
                assert c.tokens == ref[uid], uid
        reasons = {u: c.reason for u, c in router.completions.items()}
        if mode == "retry":
            assert router.stats["deadline_retries"] >= 1
            assert "deadline" not in reasons.values()
        else:
            assert "deadline" in reasons.values()
        out.append((router.stats, _tokens(router), reasons,
                    {u: c.replays for u, c in router.completions.items()}))
    assert out[0] == out[1]


def test_unmeetable_deadline_rejected_like_jax(sides):
    out = []
    for side in sides:
        f, R = side.fleet, side.serve.Request
        policy = f.FleetPolicy(
            classes=(f.SLOClass("interactive", 0, deadline_s=30.0),
                     f.SLOClass("batch", 1)), step_floor_s=1.0)
        router = f.FleetRouter(_replicas(side), policy)
        # 16 tokens = 2 chunks, + 6 tokens: 7 steps past a 3 s deadline
        got = [router.submit(R(uid="tight", prompt=[1] * 16,
                               max_new_tokens=6), deadline_s=3.0),
               router.submit(R(uid="ok", prompt=[1] * 16,
                               max_new_tokens=6))]
        router.drain()
        out.append((got, dict(router.rejected), _tokens(router)))
    assert out[0] == out[1]
    assert out[1][1] == {"tight": "deadline_unmeetable"}


HEDGES = ["win", "loss"]


@pytest.mark.parametrize("mode", HEDGES)
def test_hedging_matches_jax(sides, mode):
    out = []
    for side in sides:
        f = side.fleet
        if mode == "win":
            reqs = _reqs(side, n=2, new=5, seed0=400)
            policy = f.FleetPolicy(
                classes=(f.SLOClass("interactive", 0, hedge_after_s=3.0),
                         f.SLOClass("batch", 1)),
                max_replica_faults=10_000)
            # every window on r0 raises: its requests stall, and their
            # hedges on r1 commit first
            fault = lambda r: side.faults.failing_windows(  # noqa: E731
                r.replicas[0].batcher, nth=1, count=10_000)
        else:
            reqs = _reqs(side, n=2, new=8, seed0=500)
            policy = f.FleetPolicy(
                classes=(f.SLOClass("interactive", 0, hedge_after_s=1.0),
                         f.SLOClass("batch", 1)))
            fault = None
        ref = _reference(side, reqs)
        router = _clocked(side, policy, reqs, 200, fault)
        assert _tokens(router) == ref
        assert not router._hedges
        if mode == "win":
            assert router.stats["hedge_wins"] >= 1
            assert any(c.hedged for c in router.completions.values())
        else:
            assert router.stats["hedges"] >= 1
            assert router.stats["hedge_losses"] >= 1
            for r in router.replicas:
                cache = r.batcher.cache
                assert r.batcher.live_slots == 0
                assert (cache.allocator.num_free + cache.prefix_index_size
                        == cache.config.num_pages - 1)
        out.append((router.stats, _tokens(router),
                    {u: (c.hedged, c.replica)
                     for u, c in router.completions.items()}))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the brownout ladder
# ---------------------------------------------------------------------------


def test_brownout_ladder_matches_jax(sides):
    """Queue pressure walks both ladders up to the shedding rung and back
    down, level for level at every step; the levers change no token."""
    out = []
    for side in sides:
        f, R = side.fleet, side.serve.Request
        reqs = _reqs(side, n=6, new=4)
        ref = _reference(side, reqs)
        bp = f.BrownoutPolicy(page_frac=(0.0, 0.0, 0.0),
                              queue_depth=(2, 3, 4), chunk_throttle=2,
                              recover_margin=1.5)
        router = f.FleetRouter(_replicas(side, n=1), f.FleetPolicy(
            brownout=bp))
        for r in reqs:
            assert router.submit(r)
        router.step()
        b = router.replicas[0].batcher
        levers = (router.brownout_level, b.speculation_enabled,
                  b.chunk_throttle)
        shed = router.submit(R(uid="shed", prompt=[1, 2, 3],
                               max_new_tokens=2), "batch")
        keep = router.submit(R(uid="keep", prompt=[1, 2, 4],
                               max_new_tokens=2), "interactive")
        levels = [router.brownout_level]
        while router.step():
            levels.append(router.brownout_level)
        levels.append(router.brownout_level)
        toks = _tokens(router)
        assert {u: toks[u] for u in ref} == ref
        out.append((levers, shed, keep, dict(router.rejected), levels,
                    router.stats, toks))
    assert out[0] == out[1]
    levers, shed, keep, rejected, levels = out[1][:5]
    assert levers == (3, False, 2) and (shed, keep) == (False, True)
    assert rejected == {"shed": "brownout"}
    assert levels[-1] < 3 and out[1][5]["brownout_transitions"] >= 2


def test_page_pressure_rung_matches_jax(sides):
    out = []
    for side in sides:
        f = side.fleet
        bp = f.BrownoutPolicy(page_frac=(0.9, 0.05, 0.01),
                              queue_depth=(10_000,) * 3)
        router = f.FleetRouter(_replicas(side, n=1),
                               f.FleetPolicy(brownout=bp))
        cache = router.replicas[0].batcher.cache
        levels = []
        with side.faults.exhaust_pool(cache, leave_free=1) as stolen:
            router.step()
            levels.append(router.brownout_level)
            n_stolen = len(stolen)
        for _ in range(4):
            router.step()
            levels.append(router.brownout_level)
        out.append((levels, n_stolen, cache.allocator.num_free))
    assert out[0] == out[1]
    assert out[1][0][0] >= 1 and out[1][0][-1] == 0


@pytest.mark.parametrize("what, kw", [
    ("3 rungs", dict(page_frac=(0.3, 0.1))),
    ("non-increasing", dict(page_frac=(0.1, 0.2, 0.05))),
    ("non-decreasing", dict(queue_depth=(8, 4, 16))),
    ("chunk_throttle", dict(chunk_throttle=1)),
    ("recover_margin", dict(recover_margin=1.0))],
    ids=["rungs", "page-frac", "queue-depth", "throttle", "margin"])
def test_brownout_policy_validation_matches_jax(sides, what, kw):
    msgs = []
    for side in sides:
        side.fleet.BrownoutPolicy()
        with pytest.raises(ValueError, match=what) as err:
            side.fleet.BrownoutPolicy(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# port-only: cancel mid speculation, the checkpoint seams
# ---------------------------------------------------------------------------


def test_cancel_mid_speculation_window_is_safe(sides):
    tm = sides[1].model
    NEW, K, maxp = 8, 3, 12
    pps = -(-(maxp + NEW) // PAGE)
    cfg = tkv.KVCacheConfig(num_layers=2, num_heads=4, head_dim=16,
                            num_pages=1 + 2 * pps, page_size=PAGE,
                            max_seqs=2, pages_per_seq=pps,
                            dtype=torch.float32)
    fns = tm.decode_fns(cfg, max_prompt_len=maxp, speculate_k=K)
    rng = np.random.RandomState(3)
    prompts = []
    for n in (12, 11, 10):
        pat = rng.randint(1, 256, (4,))
        prompts.append([int(t) for t in np.tile(pat, 3)[:n]])
    reqs = [tserve.Request(uid=f"s{i}", prompt=list(p), max_new_tokens=NEW)
            for i, p in enumerate(prompts)]

    def batcher():
        return tserve.ContinuousBatcher(
            fns.prefill, fns.decode, tkv.PagedKVCache(cfg),
            tkv.init_pools(cfg, "cpu"), max_prompt_len=maxp,
            harvest_every=3, spec_fn=fns.spec, speculate_k=K,
            draft_source=NGramDraftSource(K))

    ref = {u: c.tokens for u, c in batcher().run(list(reqs)).items()}
    b = batcher()
    q = collections.deque(reqs)
    b.pump(q)
    assert b.live_slots == 2
    got = b.cancel("s0")
    assert got is not None and got == ref["s0"][:len(got)]
    assert b.cancel("s0") is None
    while b.live_slots or q:
        b.pump(q)
    assert "s0" not in b.completions
    assert b.completions["s1"].tokens == ref["s1"]
    assert b.completions["s2"].tokens == ref["s2"]
    assert b.cache.allocator.num_free == cfg.num_pages - 1
    assert b.spec_stats["accepted"] > 0


class Capture:
    """A batcher logger recording events and gauges, wall times left
    out."""

    TIMES = ("dur_s", "dispatch_s", "draft_s", "ttft_s", "duration_s")

    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append(("event", kind, {
            k: v for k, v in fields.items() if k not in self.TIMES}))

    def gauge(self, name, value):
        self.records.append(("gauge", name, value))


def _spec_logged(side, jax_side):
    """Monolithic prefill and chain speculation (an n-gram draft of 3)
    through one batcher with a logger; one request cancelled mid-run."""
    from apex_tpu.serving import NGramDraftSource as JNGram

    NEW, K, maxp = 8, 3, 12
    pps = -(-(maxp + NEW) // PAGE)
    kv = side.kv
    cfg = kv.KVCacheConfig(num_layers=2, num_heads=4, head_dim=16,
                           num_pages=1 + 2 * pps, page_size=PAGE,
                           max_seqs=2, pages_per_seq=pps,
                           dtype=torch.float32 if side.kv is tkv
                           else jnp.float32)
    if side is jax_side:
        fns = side.model(cfg, max_prompt_len=maxp, speculate_k=K)
        pools, draft = kv.init_pools(cfg), JNGram(K)
    else:
        fns = side.decode_fns(cfg, max_prompt_len=maxp, speculate_k=K)
        pools, draft = kv.init_pools(cfg, "cpu"), NGramDraftSource(K)
    rng = np.random.RandomState(3)
    reqs = []
    for i, n in enumerate((12, 11, 10)):
        pat = rng.randint(1, 256, (4,))
        reqs.append(side.serve.Request(
            uid=f"s{i}", prompt=[int(t) for t in np.tile(pat, 3)[:n]],
            max_new_tokens=NEW))
    cap = Capture()
    b = side.serve.ContinuousBatcher(
        fns.prefill, fns.decode, kv.PagedKVCache(cfg), pools,
        max_prompt_len=maxp, harvest_every=3, spec_fn=fns.spec,
        speculate_k=K, draft_source=draft, logger=cap)
    q = collections.deque(reqs)
    b.pump(q)
    b.cancel("s0")
    while b.live_slots or q:
        b.pump(q)
    return cap.records, {u: c.tokens for u, c in b.completions.items()}


def test_batcher_logger_matches_jax(sides):
    """The batcher's ``logger=`` records on a speculative, monolithic
    run with a cancel are JAX's: admissions, prefill and decode spans
    (with the weight stream's fields), one ``spec_accept`` a verify step,
    completions, the cancel, the gauges."""
    j, t = (_spec_logged(s, sides[0]) for s in sides)
    assert t[1] == j[1]
    kinds = [r[1] for r in t[0]]
    for k in ("request_admitted", "span", "spec_accept", "request_done",
              "request_cancelled", "pages_free", "live_slots"):
        assert k in kinds
    assert t[0] == j[0]


def _seam_drill(name, ckpt, faults, root, tree):
    """One checkpoint write fault over a package's seams: the save lands
    anyway (a retry, the parked copy put back, a SIGTERM that only
    marks); returns what each package must agree on."""
    import os
    import signal

    path = os.path.join(root, "ck")
    ckpt.save(path, tree)                     # the copy an overwrite parks
    got = []
    if name == "sigterm_on_write":
        prev = signal.signal(signal.SIGTERM, lambda *a: got.append("TERM"))
        try:
            with faults.sigterm_on_write(2) as patch:
                ckpt.save(path, tree)
        finally:
            signal.signal(signal.SIGTERM, prev)
        got.append(patch.write_count)
    elif name == "failing_writes":
        with faults.failing_writes(1) as patch:
            ckpt.save(path, tree)
        got += [patch.write_count, patch.matched_writes[0]]
    else:
        with faults.failing_renames(1) as count:
            ckpt.save(path, tree)
        got.append(count[0])
    got.append(ckpt.verify(path))
    got.append(sorted(os.listdir(root)))
    return got


@pytest.mark.parametrize("name", ["failing_writes", "failing_renames",
                                  "sigterm_on_write"])
def test_checkpoint_seams_wait_for_item_10(name, tmp_path, monkeypatch):
    """The checkpoint write seams, ported with the checkpoint: under each
    fault the port's save does what JAX's does (the same write-opens, one
    injected failure retried, the SIGTERM delivered mid-save) and the
    checkpoint verifies."""
    from apex_tpu import checkpoint as jckpt
    from apex_tpu_torch import checkpoint as tckpt

    monkeypatch.setenv("APEX_TPU_IO_BACKOFF_BASE", "0.001")
    tree = {"w": np.arange(6, dtype=np.float32), "n": np.int32(3)}
    jgot = _seam_drill(name, jckpt, jfaults, str(tmp_path / "j"), tree)
    tgot = _seam_drill(name, tckpt, tfaults, str(tmp_path / "t"),
                       {"w": torch.arange(6, dtype=torch.float32),
                        "n": torch.tensor(3, dtype=torch.int32)})
    assert tgot == jgot and jgot[-2] == []
