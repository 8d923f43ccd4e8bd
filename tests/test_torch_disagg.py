"""The port's disaggregated fleet, page handoff and host offload tier
against the JAX package's, on the CPU.

Page movement alone (no model): :func:`export_pages` / :func:`import_pages`
over shuffled physical pages of fp32, bf16 and int8 pools filled with the
same bits in both packages: the staged tensors equal JAX's staged arrays
byte for byte (bf16 compared as int16), in JAX's layout ``(layers,
n_pages, heads, page_size, head_dim)``; ``staged_nbytes`` equals JAX's; a
round trip is bit-identical, touches no other destination page and reads
the source only.  :class:`HostOffloadPool`'s LRU order and statistics
follow JAX's through the same operations.

Over the tiny GPT of ``tests/test_torch_fleet.py`` (vocab 256, 2 layers,
hidden 64, fp32; JAX's disaggregation test geometry: pages of 4, chunks
of 4, 24-token prompt window, 5 new tokens), in both packages:

- prefill + decode roles give the unified fleet's streams, greedy and
  seeded-sampled, every completion handed off with zero replays, and the
  port's router does what JAX's does (stats, holders, streams), also with
  a role-shaped decode replica (4 slots, harvest every 8);
- every page a handoff moves is byte-equal to the source's, and lands
  byte-equal in the destination's pool;
- the prefill replica never decodes; a staged packet is charged to its
  destination only; staging is bounded by the destination's slots;
- the offload tier under eviction pressure: pages faulted back are
  byte-equal to the pages before they left, the resumed stream equals the
  first serve and a cold recompute, and the tier's statistics are JAX's;
- a prefill replica killed mid-handoff, and the whole process lost and
  recovered from the journal, lose nothing and give the reference's
  streams, as JAX's do.

``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper,
as in ``tests/test_torch_fleet.py``.
"""

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
from apex_tpu_torch.serving import NGramDraftSource
from apex_tpu_torch.serving import kv_cache as tkv
from apex_tpu_torch.serving import serve as tserve

torch.set_num_threads(1)  # the suite's parallel workers share the cores

# ---------------------------------------------------------------------------
# page movement: no model
# ---------------------------------------------------------------------------

DTYPES = {"fp32": (jnp.float32, torch.float32, None),
          "bf16": (jnp.bfloat16, torch.bfloat16, None),
          "int8": (jnp.float32, torch.float32, "int8")}


def _cfgs(name, **kw):
    jdt, tdt, q = DTYPES[name]
    base = dict(num_layers=2, num_heads=2, head_dim=8, num_pages=12,
                page_size=4, max_seqs=2, pages_per_seq=4)
    base.update(kw)
    return (jkv.KVCacheConfig(dtype=jdt, kv_dtype=jnp.int8 if q else None,
                              **base),
            tkv.KVCacheConfig(dtype=tdt, kv_dtype=torch.int8 if q else None,
                              **base))


def _bits(x) -> np.ndarray:
    """A JAX or torch array's raw bytes as a numpy array of equal-width
    integers (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        width = {1: torch.int8, 2: torch.int16, 4: torch.int32}
        return x.contiguous().view(width[x.element_size()]).numpy()
    a = np.asarray(x)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


def _filled(name, seed):
    """The same bits in a JAX pool and a port pool."""
    jcfg, tcfg = _cfgs(name)
    rng = np.random.RandomState(seed)
    jp, tp = {}, {}
    for k, v in jkv.init_pools(jcfg).items():
        if jnp.issubdtype(v.dtype, jnp.integer):
            data = jnp.asarray(rng.randint(-127, 128, v.shape), v.dtype)
        else:
            data = jnp.asarray(rng.randn(*v.shape).astype(np.float32),
                               v.dtype)
        jp[k] = data
        t = torch.from_numpy(_bits(data).copy())
        tp[k] = t.view(tkv.init_pools(tcfg, "cpu")[k].dtype)
    return jp, tp


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_export_import_round_trip_matches_jax(name):
    jsrc, tsrc = _filled(name, seed=1)
    src_pages, dst_pages = [7, 2, 9, 4], [1, 10, 3, 6]
    jst = jkv.export_pages(jsrc, src_pages)
    tst = tkv.export_pages(tsrc, src_pages)
    assert set(tst) == set(jst)
    for k in jst:
        assert tuple(tst[k].shape) == jst[k].shape
        assert _bits(tst[k]).tobytes() == _bits(jst[k]).tobytes(), k
    assert tkv.staged_nbytes(tst) == jkv.staged_nbytes(jst)
    if name == "int8":
        assert tst["k"].dtype == torch.int8
        assert tst["k_scales"].dtype == torch.float32
    jcfg, tcfg = _cfgs(name)
    jdst = jkv.import_pages(jkv.init_pools(jcfg), jst, dst_pages)
    tdst = tkv.import_pages(tkv.init_pools(tcfg, "cpu"), tst, dst_pages)
    for k in tsrc:
        assert _bits(tdst[k]).tobytes() == _bits(jdst[k]).tobytes(), k
        assert _bits(tdst[k][:, dst_pages]).tobytes() == \
            _bits(tsrc[k][:, src_pages]).tobytes(), k


def test_import_touches_only_its_pages_and_export_only_reads():
    _, src = _filled("fp32", seed=2)
    _, dst = _filled("fp32", seed=3)
    before_src = {k: v.clone() for k, v in src.items()}
    before_dst = {k: v.clone() for k, v in dst.items()}
    tkv.import_pages(dst, tkv.export_pages(src, [5]), [8])
    others = [p for p in range(12) if p != 8]
    for k in dst:
        assert torch.equal(dst[k][:, others], before_dst[k][:, others])
        assert torch.equal(src[k], before_src[k])
    with pytest.raises(ValueError, match="compat_key"):
        tkv.import_pages(dst, {k: v.double() for k, v in
                               tkv.export_pages(src, [5]).items()}, [8])


def _offload_ops(kv, staged):
    pool = kv.HostOffloadPool(max_pages=2)
    pool.put(b"a", None, staged[1])
    pool.put(b"b", b"a", staged[2])
    pool.put(b"a", None, staged[1])            # re-warms "a"
    pool.put(b"c", b"b", staged[3])            # drops "b"
    taken = pool.take(b"a")
    missed = pool.take(b"b")
    pool.put(b"d", b"c", staged[2])
    return (list(pool._entries), dict(pool.stats), len(pool),
            b"c" in pool, pool.parent(b"c"), taken["parent"], missed)


def test_offload_pool_lru_matches_jax():
    jsrc, tsrc = _filled("int8", seed=5)
    jst = {i: jkv.export_pages(jsrc, [i]) for i in (1, 2, 3)}
    tst = {i: tkv.export_pages(tsrc, [i]) for i in (1, 2, 3)}
    assert _offload_ops(tkv, tst) == _offload_ops(jkv, jst)
    with pytest.raises(ValueError, match="max_pages"):
        tkv.HostOffloadPool(0)


def test_adopt_prefix_page_matches_jax():
    out = []
    for kv, cfg in zip((jkv, tkv), _cfgs("fp32")):
        cache = kv.PagedKVCache(cfg)
        pages = [cache.adopt_prefix_page(b"h0", None),
                 cache.adopt_prefix_page(b"h1", b"h0")]
        msgs = []
        for args in ((b"h0", None), (b"h2", b"missing")):
            with pytest.raises(ValueError) as err:
                cache.adopt_prefix_page(*args)
            msgs.append(str(err.value))
        out.append((pages, cache.prefix_index_size, msgs))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the tiny GPT's disaggregated fleet
# ---------------------------------------------------------------------------

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=4, max_position_embeddings=128)
PAGE, NEW, MAXP, CHUNK = 4, 5, 24, 4
PPS = -(-(MAXP + NEW) // PAGE)
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
            kv=jkv, serve=jserve, fleet=jfleet, dtype=jnp.float32,
            pools=jkv.init_pools,
            fns=lambda c, **kw: jm.decode_fns(params, mesh, c,
                                              max_prompt_len=MAXP, **kw),
            cache={}, runs={})
        port_side = types.SimpleNamespace(
            kv=tkv, serve=tserve, fleet=tfleet, dtype=torch.float32,
            pools=lambda c: tkv.init_pools(c, "cpu"),
            fns=lambda c, **kw: tm.decode_fns(c, max_prompt_len=MAXP, **kw),
            cache={}, runs={})
        yield jax_side, port_side
    parallel_state.destroy_model_parallel()
    assert apex_tpu._compat.shard_map is original


def _ccfg(side, slots=2, pages=None, pps=PPS):
    return side.kv.KVCacheConfig(
        num_layers=2, num_heads=4, head_dim=16,
        num_pages=pages or 1 + 4 * pps, page_size=PAGE, max_seqs=slots,
        pages_per_seq=pps, dtype=side.dtype)


def _fns(side, slots=2, pages=None, pps=PPS, sampling=None, spec=False):
    key = (slots, pages, pps, tuple(sorted((sampling or {}).items())),
           spec)
    if key not in side.cache:
        side.cache[key] = side.fns(
            _ccfg(side, slots, pages, pps), prefill_chunk=CHUNK,
            speculate_k=3 if spec else None, **(sampling or {}))
    return side.cache[key]


def _batcher(side, slots=2, harvest=2, sampling=None, spec=False,
             pages=None, pps=PPS, offload=None):
    f = _fns(side, slots, pages, pps, sampling, spec)
    c = _ccfg(side, slots, pages, pps)
    kw = (dict(spec_fn=f.spec, speculate_k=3,
               draft_source=NGramDraftSource(3)) if spec else {})
    return side.serve.ContinuousBatcher(
        f.prefill, f.decode, side.kv.PagedKVCache(c), side.pools(c),
        max_prompt_len=MAXP, harvest_every=harvest, chunk_fn=f.chunk,
        prefill_chunk=CHUNK, prefix_cache=True, offload=offload, **kw)


def _replicas(side, shaped=False, **kw):
    dec = dict(slots=4, harvest=8) if shaped else {}
    return [side.fleet.Replica("r0", _batcher(side, **kw)),
            side.fleet.Replica("r1", _batcher(side, **dict(kw, **dec)))]


def _reqs(side, seeded):
    rng = np.random.RandomState(11)
    reqs = []
    for i, plen in enumerate([12, 9, 11, 12, 10, 7]):
        pat = rng.randint(1, 256, (4,))
        reqs.append(side.serve.Request(
            uid=f"u{i}", prompt=[int(t) for t in np.tile(pat, 4)[:plen]],
            max_new_tokens=NEW, seed=100 + i if seeded else None))
    return reqs


def _tokens(router):
    return {u: c.tokens for u, c in sorted(router.completions.items())}


def _run(side, roles, seeded=False, journal=None, fail_after=None,
         **kw):
    """The six requests through a fresh 2-replica fleet; a run without a
    journal or a kill is made once a module and shared."""
    key = (roles, seeded, tuple(sorted((k, str(v)) for k, v in kw.items())))
    if journal is None and fail_after is None and key in side.runs:
        return side.runs[key]
    router = side.fleet.FleetRouter(
        _replicas(side, **kw), side.fleet.FleetPolicy(roles=roles),
        journal=journal)
    if fail_after is not None:
        router.replicas[0].fail_after(fail_after)
    for r in _reqs(side, seeded):
        assert router.submit(r)
    router.drain()
    if journal is None and fail_after is None:
        side.runs[key] = router
    return router


def _summary(router):
    return (_tokens(router), router.stats,
            {e.request.uid: e.replica for e in router.log.entries()},
            {u: (c.handoffs, c.replays) for u, c in
             router.completions.items()})


CASES = {"greedy": dict(), "seeded-sampled": dict(seeded=True,
                                                  sampling=SAMPLED),
         "role-shaped": dict(shaped=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_disagg_matches_unified_and_jax(sides, case):
    out = []
    for side in sides:
        ref = _run(side, None, **CASES[case])
        dis = _run(side, ("prefill", "decode"), **CASES[case])
        assert _tokens(dis) == _tokens(ref)
        assert dis.stats["handoffs"] >= len(ref.completions)
        assert dis.stats["handoff_pages"] > 0
        assert dis.stats["handoff_bytes"] > 0
        for c in dis.completions.values():
            assert c.handoffs >= 1 and c.replays == 0
        assert all(c.handoffs == 0 for c in ref.completions.values())
        pre, dec = dis.replicas
        assert pre.batcher.steps == 0 and dec.batcher.steps > 0
        assert not pre.batcher.decode_enabled
        out.append((_summary(ref), _summary(dis)))
    assert out[0] == out[1]


def test_disagg_matches_unified_speculative(sides):
    side = sides[1]
    ref = _run(side, None, spec=True)
    dis = _run(side, ("prefill", "decode"), spec=True)
    assert _tokens(dis) == _tokens(ref)
    assert dis.stats["handoffs"] >= 1
    assert dis.replicas[1].batcher.spec_stats["accepted"] > 0


def test_handoff_moves_pages_byte_equal(sides):
    """Every exported page's staged bytes are the source pool's, and every
    import lands them in the destination's pool unchanged."""
    side = sides[1]
    router = side.fleet.FleetRouter(_replicas(side),
                                    side.fleet.FleetPolicy(
                                        roles=("prefill", "decode")))
    pre, dec = (r.batcher for r in router.replicas)
    moved = []
    real_export, real_import = pre.export_request, dec.import_request

    def export(uid):
        slot = next(s for s, m in pre._meta.items() if m["req"].uid == uid)
        pages = list(pre.cache._slot_pages[slot])
        before = {k: v[:, pages].clone() for k, v in pre.pools.items()}
        pk = real_export(uid)
        for k, v in pk.staged.items():
            n = pk.n_pages
            assert torch.equal(v[:, :n].view(torch.int32),
                               before[k][:, :n].view(torch.int32)), k
        moved.append(pk.n_pages)
        return pk

    def import_(pk):
        if not real_import(pk):
            return False
        slot = next(s for s, m in dec._meta.items()
                    if m["req"].uid == pk.req.uid)
        pages = dec.cache._slot_pages[slot][:pk.n_pages]
        for k, v in dec.pools.items():
            assert torch.equal(v[:, pages], pk.staged[k][:, :pk.n_pages]), k
        return True

    pre.export_request, dec.import_request = export, import_
    for r in _reqs(side, seeded=False):
        assert router.submit(r)
    router.drain()
    assert len(moved) == len(router.completions) and sum(moved) == \
        router.stats["handoff_pages"]


def test_staged_packet_charges_destination_only(sides):
    out = []
    for side in sides:
        router = side.fleet.FleetRouter(
            _replicas(side), side.fleet.FleetPolicy(
                roles=("prefill", "decode")))
        pre, dec = router.replicas
        real_import = dec.batcher.import_request
        dec.batcher.import_request = lambda pk: False
        assert router.submit(_reqs(side, seeded=False)[0])
        for _ in range(40):
            router.step()
            if router._handoffs:
                break
        pk = router._handoffs[0]
        with_pk = router._load(dec), router._load(pre)
        staged, router._handoffs = router._handoffs, []
        without = router._load(dec), router._load(pre)
        router._handoffs = staged
        assert with_pk[0] - without[0] == pytest.approx(
            router.policy.w_slots)
        assert with_pk[1] == without[1]
        state = (len(router._handoffs), pk["src"], pk["dst"],
                 pre.batcher.live_slots, router._inbound("r1"),
                 router._inbound("r0"))
        dec.batcher.import_request = real_import
        router.drain()
        out.append((state, router.completions["u0"].handoffs))
    assert out[0] == out[1] == (((1, "r0", "r1", 0, 1, 0)), 1)


def test_staging_bounded_by_destination_slots(sides):
    out = []
    for side in sides:
        router = side.fleet.FleetRouter(
            _replicas(side), side.fleet.FleetPolicy(
                roles=("prefill", "decode")))
        router.replicas[1].batcher.import_request = lambda pk: False
        for r in _reqs(side, seeded=False):
            assert router.submit(r)
        for _ in range(60):
            router.step()
        out.append(len(router._handoffs))
    assert out[0] == out[1] and 0 < out[1] <= 2


def _tight(side):
    return dict(slots=2, pages=9, pps=4)


def test_offload_fault_in_bit_identical_and_matches_jax(sides):
    """A pool too small for three prompts' prefix pages: serving B and C
    evicts A's into the host tier; A again faults them back, byte-equal to
    the pages before they left, and streams A's tokens."""
    out = []
    pA = list(range(1, 13))
    for side in sides:
        R = side.serve.Request
        off = side.kv.HostOffloadPool(max_pages=16)
        b = _batcher(side, offload=off, **_tight(side))
        r1 = b.run([R(uid="a1", prompt=pA, max_new_tokens=4,
                      seed=3)])["a1"]
        hashes = side.kv.prompt_page_hashes(pA, PAGE)
        kept = [b.cache._prefix[h]["page"] for h in hashes]
        before = side.kv.export_pages(b.pools, kept)
        b.run([R(uid="b1", prompt=list(range(30, 42)), max_new_tokens=4,
                 seed=4)])
        b.run([R(uid="c1", prompt=list(range(50, 62)), max_new_tokens=4,
                 seed=5)])
        assert off.stats["offloaded"] > 0 and off.stats["bytes_in"] > 0
        assert not all(h in b.cache._prefix for h in hashes)
        r2 = b.run([R(uid="a2", prompt=pA, max_new_tokens=4,
                      seed=3)])["a2"]
        assert off.stats["faulted"] > 0 and off.stats["bytes_out"] > 0
        back = side.kv.export_pages(
            b.pools, [b.cache._prefix[h]["page"] for h in hashes])
        for k in before:
            assert _bits(back[k]).tobytes() == _bits(before[k]).tobytes()
        cold = _batcher(side, **_tight(side)).run(
            [R(uid="a2", prompt=pA, max_new_tokens=4, seed=3)])["a2"]
        assert r2.tokens == cold.tokens == r1.tokens
        out.append((r2.tokens, dict(off.stats), b.prefix_stats,
                    b.prefill_chunks, list(off._entries)))
    assert out[0] == out[1]


def test_offload_requires_prefix_cache(sides):
    side = sides[1]
    f = _fns(side)
    c = _ccfg(side)
    with pytest.raises(ValueError, match="prefix_cache"):
        tserve.ContinuousBatcher(
            f.prefill, f.decode, tkv.PagedKVCache(c), tkv.init_pools(c,
                                                                     "cpu"),
            max_prompt_len=MAXP, offload=tkv.HostOffloadPool(max_pages=4))


def test_prefill_death_mid_handoff_matches_jax(sides, tmp_path):
    out = []
    for side in sides:
        name = side.serve.__name__
        ref = _run(side, ("prefill", "decode"), seeded=True,
                   sampling=SAMPLED)
        jr = side.fleet.RequestJournal(str(tmp_path / f"{name}.jsonl"))
        drill = _run(side, ("prefill", "decode"), seeded=True,
                     sampling=SAMPLED, journal=jr, fail_after=2)
        jr.close()
        assert not drill.replicas[0].alive
        assert sorted(drill.completions) == sorted(ref.completions)
        assert _tokens(drill) == _tokens(ref)
        assert drill.log.pending() == 0
        out.append(_summary(drill))
    assert out[0] == out[1]


def test_process_death_recovers_via_journal_like_jax(sides, tmp_path):
    out = []
    for side in sides:
        path = str(tmp_path / f"{side.serve.__name__}.jsonl")
        ref = _run(side, ("prefill", "decode"), seeded=True,
                   sampling=SAMPLED)
        jr = side.fleet.RequestJournal(path)
        router = side.fleet.FleetRouter(
            _replicas(side, sampling=SAMPLED),
            side.fleet.FleetPolicy(roles=("prefill", "decode")), journal=jr)
        for r in _reqs(side, seeded=True):
            assert router.submit(r)
        for _ in range(6):
            router.step()
        handed = router.stats["handoffs"]
        jr.close()
        recovery = side.fleet.recover_journal(path)
        assert len(recovery.entries) == 6
        jr2 = side.fleet.RequestJournal(path)
        restarted = side.fleet.FleetRouter(
            _replicas(side, sampling=SAMPLED),
            side.fleet.FleetPolicy(roles=("prefill", "decode")),
            journal=jr2)
        res = restarted.resume_from_journal(recovery)
        assert res["corrupt"] == 0
        restarted.drain()
        jr2.close()
        assert _tokens(restarted) == _tokens(ref)
        out.append((handed, res, _tokens(restarted), restarted.stats))
    assert out[0] == out[1]
