"""Speculative decoding in the port, against the JAX package.

- The candidate-tree helpers and ``NGramDraftSource`` proposals equal the
  JAX package's on the same trees and contexts (host code on both sides:
  exact).
- ``spec_accept`` / ``spec_accept_tree`` equal JAX's (greedy) on the same
  logits, drafts and masks: exact integers.
- ``verify_step`` logits and pools, a chain and a tree (``offramp_tree``),
  fp32 and int8 pages, equal JAX ``verify_step`` on the same pools (fp32
  within 1e-5, int8 values within one quantization step), and the tree's
  stashed K/V rows too.
- ``generate(speculate_k=4)`` from n-gram drafts, and from an int4
  ``ModelDraftSource`` (the target's own weights quantized) under a chain
  and under ``offramp_tree(4)``, gives JAX ``generate_reference``'s greedy
  tokens exactly, on the tiny GPT of ``tests/test_torch_serving.py``
  (learned positions and the Llama mode).  Drafts must actually be
  accepted, so the verify path commits several tokens a step.

``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper
(jax 0.9's vma check), and the model-parallel state is destroyed before
and after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu._compat
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.serving import sampling as jsampling
from apex_tpu.serving import speculate as jspec
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serving import (
    ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools,
    sampling as tsampling, speculate as tspec,
)

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=64)
LLAMA = dict(position_embedding="rope", activation="swiglu",
             normalization="rmsnorm")
K = 4
NEW = 16
PAGE = 4
TREES = [jspec.chain_tree(1), jspec.chain_tree(4), jspec.offramp_tree(2),
         jspec.offramp_tree(4), (-1, 0, 0, 1, 1, 2, 3)]


@pytest.mark.parametrize("tree", TREES, ids=str)
def test_tree_helpers_match_jax(tree):
    for name in ("validate_tree", "tree_depths", "tree_max_depth",
                 "tree_ancestors", "tree_chain_rows"):
        assert getattr(tspec, name)(tree) == getattr(jspec, name)(tree)
    for k in (1, 3, 4):
        assert tspec.chain_tree(k) == jspec.chain_tree(k)
        assert tspec.offramp_tree(k) == jspec.offramp_tree(k)
    for bad in ((), (0,), (-1, 1), (-1, 0, 3)):
        with pytest.raises(ValueError):
            jspec.validate_tree(bad)
        with pytest.raises(ValueError):
            tspec.validate_tree(bad)


def test_ngram_drafts_match_jax():
    rng = np.random.RandomState(0)
    for trial in range(40):
        base = rng.randint(0, 6, rng.randint(1, 30)).tolist()
        ctx = base + base[: rng.randint(0, len(base) + 1)]
        plen = rng.randint(1, len(ctx) + 1)
        for k, lo, hi in ((4, 1, 3), (2, 2, 2), (6, 1, 1)):
            j = jspec.NGramDraftSource(k, max_ngram=hi, min_ngram=lo)
            t = tspec.NGramDraftSource(k, max_ngram=hi, min_ngram=lo)
            assert t.draft(ctx, plen) == j.draft(ctx, plen), (trial, k)
    assert tspec.NullDraftSource(3).draft([1, 1, 1], 1) == ([], None)


def _logits_and_drafts(seed, rows, slots=5):
    """Logits whose argmax rows the drafts partly follow, so accepted
    prefixes of every length occur."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(slots, rows, 16).astype(np.float32)
    arg = logits.argmax(-1)
    drafts = rng.randint(0, 16, (slots, rows - 1)).astype(np.int32)
    for s in range(slots):
        keep = rng.randint(0, rows)
        drafts[s, :keep] = arg[s, :keep]
    return logits, drafts


def test_spec_accept_matches_jax():
    logits, drafts = _logits_and_drafts(1, K + 1)
    dlen = np.array([0, 1, 4, 4, 2], np.int32)
    t, n = tsampling.spec_accept(torch.from_numpy(logits),
                                 torch.from_numpy(drafts),
                                 torch.from_numpy(dlen))
    for s in range(5):
        jt, jn = jsampling.spec_accept(jnp.asarray(logits[s]),
                                       jnp.asarray(drafts[s]),
                                       jnp.int32(dlen[s]), None)
        np.testing.assert_array_equal(t[s].numpy(), np.asarray(jt))
        assert int(n[s]) == int(jn)
    assert t.dtype == torch.int32 and sorted(set(n.tolist())) != [0]
    # sampled: per-row keys, JAX's draws and prefix (tests of every
    # temperature/top-k/top-p in tests/test_torch_sampling.py)
    keys = np.stack([np.stack([np.asarray(jax.random.fold_in(
        jax.random.PRNGKey(7 + s), 20 + j)) for j in range(K + 1)])
        for s in range(5)])
    t, n = tsampling.spec_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(dlen), torch.from_numpy(keys.astype(np.int64)),
        temperature=0.5, top_k=8)
    for s in range(5):
        jt, jn = jsampling.spec_accept(
            jnp.asarray(logits[s]), jnp.asarray(drafts[s]),
            jnp.int32(dlen[s]), jnp.asarray(keys[s]), 0.5, 8)
        np.testing.assert_array_equal(t[s].numpy(), np.asarray(jt))
        assert int(n[s]) == int(jn)
    with pytest.raises(ValueError, match="PRNG keys"):
        tsampling.spec_accept(torch.from_numpy(logits),
                              torch.from_numpy(drafts),
                              torch.from_numpy(dlen), temperature=0.5)


@pytest.mark.parametrize("tree", [jspec.offramp_tree(4), TREES[-1],
                                  jspec.chain_tree(4)], ids=str)
def test_spec_accept_tree_matches_jax(tree):
    R = len(tree)
    logits, drafts = _logits_and_drafts(2, R, slots=8)
    rng = np.random.RandomState(3)
    depths = jspec.tree_depths(tree)
    # off-ramp rows carry the parent's argmax on some slots
    arg = logits.argmax(-1)
    for s in range(8):
        for r in range(1, R):
            if rng.rand() < 0.4:
                drafts[s, r - 1] = arg[s, tree[r]]
    valid = np.array([[depths[r] <= rng.randint(0, K + 1)
                       for r in range(1, R)] for _ in range(8)])
    out, n, path = tsampling.spec_accept_tree(
        torch.from_numpy(logits), torch.from_numpy(drafts), tree,
        torch.from_numpy(valid))
    for s in range(8):
        jo, jn, jp = jsampling.spec_accept_tree(
            jnp.asarray(logits[s]), jnp.asarray(drafts[s]), tree,
            jnp.asarray(valid[s]), None)
        np.testing.assert_array_equal(out[s].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(path[s].numpy(), np.asarray(jp))
        assert int(n[s]) == int(jn)
    assert int(n.max()) >= 2


@pytest.fixture(scope="module")
def mesh():
    original = apex_tpu._compat.shard_map

    def shard_map(f, mesh, in_specs, out_specs, check=True):
        return original(f, mesh, in_specs, out_specs, check=False)

    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(apex_tpu._compat, "shard_map", shard_map)
        yield parallel_state.initialize_model_parallel(
            devices=jax.devices()[:1])
    parallel_state.destroy_model_parallel()
    assert apex_tpu._compat.shard_map is original


def _prompts():
    """Four prompts with repetition (a period-3 pattern in rows 0 and 2),
    so n-gram drafts find matches, and two without."""
    rng = np.random.RandomState(11)
    prompts = rng.randint(1, 64, (4, 12)).astype(np.int32)
    prompts[0] = np.tile(prompts[0, :3], 4)
    prompts[2, :9] = np.tile(prompts[2, :3], 3)
    plens = np.array([12, 7, 9, 10], np.int32)
    for i in range(4):
        prompts[i, plens[i]:] = 0
    return prompts, plens


@pytest.fixture(scope="module", params=["learned", "rope"])
def models(request, mesh):
    extra = LLAMA if request.param == "rope" else {}
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, **extra,
                                  compute_dtype=jnp.float32, remat=False,
                                  attention_impl="xla"))
    rng = np.random.RandomState(3)
    std = 0.5 if request.param == "rope" else 0.2
    params = jax.tree.map(
        lambda x: (std * rng.randn(*x.shape)).astype(np.float32),
        jm.init(jax.random.PRNGKey(0)))
    tm = GPTModel(GPTConfig(**SIZES, **extra, compute_dtype=torch.float32),
                  device="cpu")
    tm.load_state_dict(convert.params_from_jax(params))
    prompts, plens = _prompts()
    ref = np.asarray(jm.generate_reference(params, prompts, plens, NEW,
                                           mesh=mesh))
    return jm, params, tm, prompts, plens, ref


def _verify_inputs(tree, kv_int8, seed):
    rng = np.random.RandomState(seed)
    S, R = 3, (K + 1 if tree is None else len(tree))
    shape = (2, 24, 4, PAGE, 8)
    if kv_int8:
        pools = {n: rng.randint(-127, 128, shape).astype(np.int8)
                 for n in ("k", "v")}
        pools.update({n: rng.uniform(0.01, 0.05, shape[:-1] + (2,))
                      .astype(np.float32) for n in ("k_scales", "v_scales")})
    else:
        pools = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    table = rng.permutation(np.arange(1, 24))[:S * 6].reshape(S, 6)
    lengths = np.array([5, 13, 21], np.int32)     # the last runs off the end
    tokens = rng.randint(1, 64, (S, R)).astype(np.int32)
    valid = np.ones((S, R), bool)
    valid[0, 3:] = False
    active = np.array([True, True, True])
    return pools, table.astype(np.int32), lengths, tokens, valid, active


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32kv", "int8kv"])
@pytest.mark.parametrize("tree", [None, jspec.offramp_tree(K)],
                         ids=["chain", "offramp4"])
def test_verify_step_matches_jax(models, mesh, tree, kv_int8):
    jm, params, tm, _, _, _ = models
    pools, table, lengths, tokens, valid, active = _verify_inputs(
        tree, kv_int8, seed=4 + kv_int8)
    kw = dict(quantized=kv_int8, kv_block=4, tree=tree)

    def f(p, pools, tokens, lengths, active, valid, table):
        return jm.verify_step(p, tokens, lengths, active, valid, table,
                              pools, **kw)

    n_out = 2 if tree is None else 3
    fn = jax.jit(apex_tpu._compat.shard_map(
        f, mesh=mesh, in_specs=(P(),) * 7, out_specs=(P(),) * n_out))
    want = fn(params, {k: jnp.asarray(v) for k, v in pools.items()},
              *(jnp.asarray(a) for a in (tokens, lengths, active, valid,
                                         table)))
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    with torch.no_grad():
        got = tm.verify_step(*(torch.from_numpy(a) for a in (
            tokens, lengths, active, valid, table)), tpools, **kw)
    assert len(got) == n_out
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for name, w in want[1].items():
        g, w = got[1][name].numpy(), np.asarray(w)
        if g.dtype == np.int8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    if tree is not None:
        for g, w in zip(got[2], want[2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def _want(ref):
    return [list(map(int, r)) for r in ref]


def _spec_batcher(tm, tree=None, draft=None, kv_dtype=None):
    pps = -(-(12 + NEW + K) // PAGE)
    ccfg = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                         num_pages=1 + 2 * pps, page_size=PAGE, max_seqs=2,
                         pages_per_seq=pps, dtype=torch.float32,
                         kv_dtype=kv_dtype, kv_block=4)
    fns = tm.decode_fns(ccfg, max_prompt_len=12, speculate_k=K,
                        spec_tree=tree, draft_model=draft)
    return ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg), init_pools(ccfg, "cpu"),
        max_prompt_len=12, harvest_every=4, spec_fn=fns.spec, speculate_k=K)


def _draft_model(tm, tree):
    dcfg = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                         num_pages=1 + 2 * 8, page_size=PAGE, max_seqs=2,
                         pages_per_seq=8, dtype=torch.float32)
    # weight_block=16: the qkv rows (96) tile 2 * block for int4 halves
    return tspec.ModelDraftSource(tm, dcfg, k=K, tree=tree,
                                  weight_dtype="int4", weight_block=16,
                                  ingest_chunk=4)


def test_ngram_speculation_matches_reference(models):
    _, _, tm, prompts, plens, ref = models
    got = tm.generate(prompts, plens, NEW, page_size=PAGE, max_seqs=2,
                      harvest_every=4, speculate_k=K)
    assert got == _want(ref)
    b = _spec_batcher(tm)
    comps = b.run([Request(uid=i, prompt=prompts[i, :plens[i]].tolist(),
                           max_new_tokens=NEW) for i in range(4)])
    assert [comps[i].tokens for i in range(4)] == _want(ref)
    st = b.spec_stats
    assert st["committed"] == 4 * (NEW - 1) and st["drafted"] > 0
    assert b.cache.allocator.num_free == b.cache.config.num_pages - 1


@pytest.mark.parametrize("tree", [None, jspec.offramp_tree(K)],
                         ids=["chain", "offramp4"])
def test_model_draft_speculation_matches_reference(models, tree):
    """An int4 draft of the target's own weights agrees with it often, so
    steps commit several tokens; the committed stream is greedy's."""
    _, _, tm, prompts, plens, ref = models
    draft = _draft_model(tm, tree)
    got = tm.generate(prompts, plens, NEW, page_size=PAGE, max_seqs=2,
                      harvest_every=4, speculate_k=K, draft_source=draft)
    assert got == _want(ref)
    b = _spec_batcher(tm, tree=tree, draft=_draft_model(tm, tree))
    comps = b.run([Request(uid=i, prompt=prompts[i, :plens[i]].tolist(),
                           max_new_tokens=NEW) for i in range(4)])
    assert [comps[i].tokens for i in range(4)] == _want(ref)
    st = b.spec_stats
    assert st["accepted"] > st["steps"] // 2
    assert st["committed"] / st["slot_steps"] > 1.5
    assert st["by_source"]["draft_model"]["accepted"] == st["accepted"]


def test_tree_speculation_with_int8_kv_matches_chain(models):
    """The pass-2 rewrite re-quantizes the accepted rows from their
    full-width values, so a tree verify over int8 pages commits what a
    chain verify over int8 pages commits."""
    _, _, tm, prompts, plens, _ = models
    outs = []
    for tree in (None, jspec.offramp_tree(K)):
        b = _spec_batcher(tm, tree=tree, draft=_draft_model(tm, tree),
                          kv_dtype=torch.int8)
        comps = b.run([Request(uid=i, prompt=prompts[i, :plens[i]].tolist(),
                               max_new_tokens=NEW) for i in range(4)])
        outs.append([comps[i].tokens for i in range(4)])
    assert outs[0] == outs[1]


def test_speculation_validation_matches_jax(models):
    _, _, tm, _, _, _ = models
    ccfg = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8, num_pages=9,
                         page_size=PAGE, max_seqs=2, pages_per_seq=4,
                         dtype=torch.float32)
    for kw, match in (
            (dict(spec_tree=jspec.offramp_tree(2)), "without speculate_k"),
            (dict(speculate_k=3, spec_tree=jspec.offramp_tree(2)),
             "max depth"),
            (dict(speculate_k=0), "speculate_k must be >= 1"),
            (dict(speculate_k=2, draft_model=object()), "DraftSource"),
            (dict(draft_model=tspec.NullDraftSource(2)),
             "without speculate_k"),
            (dict(speculate_k=3, draft_model=tspec.NGramDraftSource(2)),
             "drafts k=2")):
        with pytest.raises((ValueError, TypeError), match=match):
            tm.decode_fns(ccfg, max_prompt_len=8, **kw)
    fns = tm.decode_fns(ccfg, max_prompt_len=8, speculate_k=2)
    with pytest.raises(ValueError, match="speculate_k mismatch"):
        ContinuousBatcher(fns.prefill, fns.decode, PagedKVCache(ccfg),
                          init_pools(ccfg, "cpu"), max_prompt_len=8,
                          spec_fn=fns.spec, speculate_k=3)
    tree_src = tspec.NGramDraftSource(2)
    tree_src.tree = jspec.offramp_tree(2)
    with pytest.raises(ValueError, match="verifies a chain"):
        ContinuousBatcher(fns.prefill, fns.decode, PagedKVCache(ccfg),
                          init_pools(ccfg, "cpu"), max_prompt_len=8,
                          spec_fn=fns.spec, speculate_k=2,
                          draft_source=tree_src)
    with pytest.raises(ValueError, match="arbitrary trees"):
        tspec.ModelDraftSource(tm, ccfg, k=2, tree=(-1, 0, 0, 1))
