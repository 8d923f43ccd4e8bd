"""The port's serving stack against the JAX package's greedy reference.

The tiny GPT of ``tests/test_serving.py`` (vocab 64, 2 layers, hidden
32, 4 heads, fp32 compute), with its leaves redrawn from a numpy seed
(std 0.2, so that greedy streams vary) and fed to both packages.  The
JAX ``generate_reference`` (full recompute, no cache) is the oracle;
the port serves the same six ragged prompts through its paged cache,
decode kernel path and ``ContinuousBatcher`` in two slots, so each slot
sees three admit/retire generations.  Greedy tokens must be identical,
token for token: at fp32 compute the two frameworks' logits agree to
about 1e-6, far inside the gaps between the top two logits here.

``generate_reference`` wraps its step in ``apex_tpu._compat.shard_map``
with the vma check on, which jax 0.9 rejects for this model; a
module-scoped fixture swaps in a ``check=False`` wrapper and restores
the original afterwards.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu._compat
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.serving.sampling import sample as jsample
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serving import (
    CacheOutOfPages, ContinuousBatcher, KVCacheConfig, PageAllocator,
    PagedKVCache, Request, greedy, init_pools, sample, write_targets,
    write_tokens,
)

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=64)
NEW = 12
PAGE = 4


@pytest.fixture(scope="module")
def unchecked_shard_map():
    original = apex_tpu._compat.shard_map

    def shard_map(f, mesh, in_specs, out_specs, check=True):
        return original(f, mesh, in_specs, out_specs, check=False)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(apex_tpu._compat, "shard_map", shard_map)
        yield
    assert apex_tpu._compat.shard_map is original


@pytest.fixture(scope="module")
def jax_setup(unchecked_shard_map):
    """The JAX model, its redrawn leaves, the mesh and the prompts."""
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        devices=jax.devices()[:1])
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, compute_dtype=jnp.float32,
                                  remat=False, attention_impl="xla"))
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32),
        jm.init(jax.random.PRNGKey(0)))
    prompts = rng.randint(1, 64, (6, 10)).astype(np.int32)
    plens = np.array([10, 8, 6, 4, 9, 5], np.int32)
    for i in range(6):
        prompts[i, plens[i]:] = 0
    yield jm, params, mesh, prompts, plens
    parallel_state.destroy_model_parallel()


@pytest.fixture(scope="module")
def setup(jax_setup):
    jm, params, mesh, prompts, plens = jax_setup
    ref = jm.generate_reference(params, prompts, plens, NEW, mesh=mesh)
    tm = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                  device="cpu")
    tm.load_state_dict(convert.params_from_jax(params))
    yield tm, prompts, plens, np.asarray(ref)


def _batcher(tm, max_seqs, harvest_every, eos_id=None):
    pps = -(-(10 + NEW) // PAGE)
    ccfg = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                         num_pages=1 + max_seqs * pps, page_size=PAGE,
                         max_seqs=max_seqs, pages_per_seq=pps,
                         dtype=torch.float32)
    fns = tm.decode_fns(ccfg, max_prompt_len=10, eos_id=eos_id)
    return ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg),
        init_pools(ccfg, "cpu"), max_prompt_len=10,
        harvest_every=harvest_every, eos_id=eos_id)


def _requests(prompts, plens):
    return [Request(uid=i, prompt=[int(t) for t in prompts[i, :plens[i]]],
                    max_new_tokens=NEW) for i in range(6)]


def test_reference_streams_are_not_degenerate(setup):
    tm, prompts, plens, ref = setup
    assert len({tuple(r) for r in ref}) == 6
    assert all(len(set(r)) > 2 for r in ref)


def test_port_reference_matches_jax_reference(setup):
    tm, prompts, plens, ref = setup
    np.testing.assert_array_equal(
        tm.generate_reference(prompts, plens, NEW), ref)


@pytest.mark.parametrize("harvest_every", [1, 3, 8])
def test_batcher_greedy_tokens_match_jax_under_churn(setup, harvest_every):
    """6 requests through 2 slots: three admit/retire generations."""
    tm, prompts, plens, ref = setup
    b = _batcher(tm, max_seqs=2, harvest_every=harvest_every)
    shapes = {k: (v.shape, v.data_ptr()) for k, v in b.pools.items()}
    comps = b.run(_requests(prompts, plens))
    assert len(comps) == 6
    for i in range(6):
        assert comps[i].tokens == list(map(int, ref[i])), i
        assert comps[i].reason == "budget"
    # the pools are updated in place: same tensors, same shapes
    assert {k: (v.shape, v.data_ptr()) for k, v in b.pools.items()} == shapes
    assert b.cache.allocator.num_free == b.cache.config.num_pages - 1


def test_eos_truncates_raggedly(setup):
    tm, prompts, plens, ref = setup
    flat = [int(t) for r in ref for t in r]
    eos = max(set(flat), key=flat.count)
    comps = _batcher(tm, 2, 3, eos_id=eos).run(_requests(prompts, plens))
    finishes = set()
    for i in range(6):
        want = list(map(int, ref[i]))
        if eos in want:
            want = want[:want.index(eos) + 1]
            assert comps[i].reason == "eos"
        assert comps[i].tokens == want, i
        finishes.add(len(want))
    assert len(finishes) > 1


def test_generate_matches_jax_reference(setup):
    tm, prompts, plens, ref = setup
    out = tm.generate(prompts, plens, NEW, page_size=PAGE, max_seqs=3,
                      harvest_every=4)
    assert out == [list(map(int, r)) for r in ref]


def test_unported_serving_options_raise(setup, jax_setup):
    """Tensor parallelism (queue A item 9a) is ported: ``decode_fns(tp=)``
    is checked against the tensor-parallel group, as JAX's against its
    mesh, and a degree the model was not built for raises (the tp > 1
    steps are held in ``tests/test_torch_tp_decode.py``); the metrics logger is ported (its records are held to JAX's in
    ``tests/test_torch_telemetry.py``); the host offload tier is ported and, as
    in JAX, needs the prefix cache; chunked prefill, the prefix cache and
    speculation are ported and build, and so is sampling
    (item 3): temperature, top-k and top-p build, ``generate`` at
    temperature > 0 gives JAX's tokens for the same key, and ``sample``
    raises JAX's ValueError without a key and draws JAX's token with
    one."""
    tm, prompts, plens, ref = setup
    jm, params, mesh, _, _ = jax_setup
    ccfg = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                         num_pages=8, page_size=PAGE, max_seqs=2,
                         pages_per_seq=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="disagrees with the tensor-"):
        tm.decode_fns(ccfg, max_prompt_len=10, tp=2)
    assert tm.decode_fns(ccfg, max_prompt_len=10, tp=1).tp == 1
    for kw in (dict(temperature=0.7), dict(top_k=5), dict(top_p=0.9)):
        assert tm.decode_fns(ccfg, max_prompt_len=10, **kw).decode
    fns = tm.decode_fns(ccfg, max_prompt_len=10, prefill_chunk=4,
                        speculate_k=2)
    assert fns.chunk.prefill_chunk == 4 and fns.spec.speculate_k == 2
    args = (fns.prefill, fns.decode, PagedKVCache(ccfg),
            init_pools(ccfg, "cpu"))
    logger = types.SimpleNamespace(event=lambda *a, **k: None,
                                   gauge=lambda *a: None)
    assert ContinuousBatcher(*args, max_prompt_len=10,
                             logger=logger).logger is logger
    with pytest.raises(ValueError, match="offload requires prefix_cache"):
        ContinuousBatcher(*args, max_prompt_len=10, offload=object())
    kw = dict(temperature=0.5, top_k=20, top_p=0.9)
    got = tm.generate(prompts, plens, 6, page_size=PAGE,
                      key=np.asarray(jax.random.PRNGKey(11)), **kw)
    want = jm.generate(params, prompts, plens, 6, mesh=mesh, page_size=PAGE,
                       key=jax.random.PRNGKey(11), **kw)
    assert got == [list(map(int, w)) for w in want]
    assert got != [list(map(int, r[:6])) for r in ref]
    with pytest.raises(ValueError, match="learned table"):
        tm.decode_fns(ccfg, max_prompt_len=2049)
    # int8 KV pages are ported; another kv_dtype raises as in JAX
    assert KVCacheConfig(num_layers=2, num_heads=4, head_dim=8, num_pages=8,
                         kv_dtype=torch.int8).quantized
    with pytest.raises(ValueError, match="kv_dtype"):
        KVCacheConfig(num_layers=2, num_heads=4, head_dim=8, num_pages=8,
                      kv_dtype=torch.float16)
    with pytest.raises(ValueError, match="PRNG key"):
        sample(torch.zeros(2, 8), temperature=1.0)
    logits = np.random.RandomState(4).randn(2, 8).astype(np.float32)
    np.testing.assert_array_equal(
        sample(torch.from_numpy(logits), np.asarray(jax.random.PRNGKey(2)),
               1.0).numpy(),
        np.asarray(jsample(jnp.asarray(logits), jax.random.PRNGKey(2),
                           1.0)))


def test_allocator_reserves_null_page_and_reuses():
    a = PageAllocator(8)
    got = a.alloc(7)
    assert 0 not in got and sorted(got) == list(range(1, 8))
    with pytest.raises(CacheOutOfPages):
        a.alloc(1)
    a.free(got[:3])
    assert a.alloc(1) == [got[2]]                  # LIFO
    with pytest.raises(ValueError):
        a.free([0])


def test_cache_writes_round_trip_and_idle_goes_to_null_page():
    cfg = KVCacheConfig(num_layers=1, num_heads=2, head_dim=4, num_pages=6,
                        page_size=4, max_seqs=2, pages_per_seq=2,
                        dtype=torch.float32)
    cache = PagedKVCache(cfg)
    cache.admit(1, 6)
    pools = init_pools(cfg, "cpu")
    table = torch.as_tensor(cache.page_table)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    active = torch.tensor([False, True])
    wp, wo = write_targets(table, pos, active, cfg.page_size)
    assert wp.tolist()[0] == 0 and wo.tolist()[0] == 0
    k_new = torch.arange(16, dtype=torch.float32).reshape(2, 2, 4)
    layer = {"k": pools["k"][0], "v": pools["v"][0]}
    write_tokens(layer, k_new, -k_new, wp, wo)
    page = cache.page_table[1, 1]
    torch.testing.assert_close(pools["k"][0, page, :, 1], k_new[1],
                               rtol=0, atol=0)
    torch.testing.assert_close(pools["v"][0, page, :, 1], -k_new[1],
                               rtol=0, atol=0)


def test_greedy_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert greedy(logits).tolist() == [1, 0]
    assert greedy(logits).dtype == torch.int32
    np.testing.assert_array_equal(
        greedy(logits).numpy(), np.asarray(jnp.argmax(logits.numpy(), -1)))
