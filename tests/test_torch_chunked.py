"""Chunked prefill and the prefix cache in the port, against the JAX
package.

The tiny GPT of ``tests/test_torch_serving.py`` (vocab 64, 2 layers,
hidden 32, 4 heads, fp32 compute) in its learned-position mode and in
its Llama mode (rope, RMSNorm, SwiGLU), every leaf redrawn from a numpy
seed and fed to both packages (std 0.2; 0.5 in the Llama mode, whose
greedy streams repeat one token at 0.2).

- ``prefill_chunk``: the same pools (random contents, fp32 or int8 pages
  with their scales), page row, chunk tokens, ``start``, ``prompt_len``
  and ``write_from`` go through the JAX method (under ``shard_map`` on a
  one-device mesh) and the port's; logits and every pool buffer must
  agree (fp32 within 1e-5; int8 values within one quantization step,
  since two fp32 values 1e-7 apart may round to neighbouring int8s).
- ``generate(prefill_chunk=4, prefix_cache=True)`` serves six ragged
  prompts that share prefixes (a partial match, and a whole-prompt match
  that takes the copy-on-write tail) through two slots: its greedy tokens
  must equal JAX ``generate_reference`` and JAX's own chunked, prefix-cached
  ``generate``, token for token (fp32 logits agree to about 1e-6, far
  inside the gaps between the top two logits here), and the same for
  int8 KV pages against JAX's int8 chunked ``generate``.
- A prefix hit's last-prompt-token logits are bit-identical
  (``torch.equal``) to a cold admission's, as the JAX package pins it.

``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper
(jax 0.9's vma check rejects these steps), and the model-parallel state
is destroyed before and after, so no mesh leaks to the next file.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu._compat
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serving import (
    ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools,
)

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=64)
LLAMA = dict(position_embedding="rope", activation="swiglu",
             normalization="rmsnorm")
NEW = 12
PAGE = 4
PLENS = np.array([10, 6, 8, 4, 9, 5], np.int32)


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
    """Six ragged prompts: row 2 is row 0's first 8 tokens (a whole-prompt
    match, the copy-on-write tail), row 4 extends them (a partial match
    that skips two chunks)."""
    rng = np.random.RandomState(5)
    prompts = rng.randint(1, 64, (6, 10)).astype(np.int32)
    prompts[2, :8] = prompts[0, :8]
    prompts[4, :8] = prompts[0, :8]
    for i in range(6):
        prompts[i, PLENS[i]:] = 0
    return prompts


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
    prompts = _prompts()
    ref = np.asarray(jm.generate_reference(params, prompts, PLENS, NEW,
                                           mesh=mesh))
    return request.param, jm, params, tm, prompts, ref


def _pools(kv_int8, seed):
    """Random pool contents as numpy arrays, fed to both sides: 2 layers
    of 16 pages (4 heads, 4 tokens, 8 dims), int8 with ``kv_block`` 4
    scales or fp32."""
    rng = np.random.RandomState(seed)
    shape = (2, 16, 4, PAGE, 8)
    if kv_int8:
        arrays = {n: rng.randint(-127, 128, shape).astype(np.int8)
                  for n in ("k", "v")}
        arrays.update({n: rng.uniform(0.01, 0.05, shape[:-1] + (2,))
                       .astype(np.float32) for n in ("k_scales", "v_scales")})
    else:
        arrays = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    return arrays


def _jax_chunk(jm, params, mesh, toks, start, plen, wf, row, pools,
               quantized):
    def f(p, pools, toks, row):
        return jm.prefill_chunk(p, toks, start, plen, wf, row, pools,
                                quantized=quantized, kv_block=4)

    fn = jax.jit(apex_tpu._compat.shard_map(
        f, mesh=mesh, in_specs=(P(), P(), P(), P()), out_specs=(P(), P())))
    return fn(params, pools, toks, row)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32kv", "int8kv"])
@pytest.mark.parametrize("C, start, plen, wf", [
    (4, 0, 10, 0), (4, 4, 10, 6), (8, 8, 13, 8), (16, 0, 13, 0)])
def test_prefill_chunk_matches_jax(models, mesh, kv_int8, C, start, plen,
                                   wf):
    _, jm, params, tm, _, _ = models
    arrays = _pools(kv_int8, seed=C + start)
    row = np.random.RandomState(7).permutation(np.arange(1, 16))[:6]
    row = row.astype(np.int32)
    toks = np.random.RandomState(C).randint(1, 64, (1, C)).astype(np.int32)
    jl, jpools = _jax_chunk(jm, params, mesh, jnp.asarray(toks), start, plen,
                            wf, jnp.asarray(row),
                            {k: jnp.asarray(v) for k, v in arrays.items()},
                            kv_int8)
    tpools = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    with torch.no_grad():
        tl, tpools = tm.prefill_chunk(torch.from_numpy(toks), start, plen, wf,
                                      torch.from_numpy(row), tpools,
                                      quantized=kv_int8, kv_block=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for name, want in jpools.items():
        got, want = tpools[name].numpy(), np.asarray(want)
        if got.dtype == np.int8:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # below write_from, and past prompt_len, nothing was written
    for name in ("k", "v"):
        for pos in list(range(start, min(wf, start + C))) + list(
                range(max(plen, start), start + C)):
            page, off = row[pos // PAGE], pos % PAGE
            np.testing.assert_array_equal(tpools[name][:, page, :, off],
                                          arrays[name][:, page, :, off])


def _batcher(tm, chunk=4, prefix=True, slots=2, kv_dtype=None):
    pps = -(-(10 + NEW) // PAGE)
    ccfg = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                         num_pages=1 + (slots + 4) * pps, page_size=PAGE,
                         max_seqs=slots, pages_per_seq=pps,
                         dtype=torch.float32, kv_dtype=kv_dtype, kv_block=4)
    fns = tm.decode_fns(ccfg, max_prompt_len=10, prefill_chunk=chunk)
    return ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg), init_pools(ccfg, "cpu"),
        max_prompt_len=10, harvest_every=3, chunk_fn=fns.chunk,
        prefill_chunk=chunk, prefix_cache=prefix)


def _want(ref):
    return [list(map(int, r)) for r in ref]


def test_chunked_prefix_cached_generate_matches_jax(models, mesh):
    kind, jm, params, tm, prompts, ref = models
    assert len({tuple(r) for r in ref}) >= 5
    got = tm.generate(prompts, PLENS, NEW, page_size=PAGE, max_seqs=2,
                      harvest_every=3, prefill_chunk=4, prefix_cache=True)
    assert got == _want(ref)
    jax_out = jm.generate(params, prompts, PLENS, NEW, mesh=mesh,
                          page_size=PAGE, max_seqs=2, harvest_every=3,
                          prefill_chunk=4, prefix_cache=True)
    assert got == [list(map(int, r)) for r in jax_out]
    # the batcher took both kinds of hit and skipped matched chunks
    b = _batcher(tm)
    comps = b.run([Request(uid=i, prompt=prompts[i, :PLENS[i]].tolist(),
                           max_new_tokens=NEW) for i in range(6)])
    assert [comps[i].tokens for i in range(6)] == _want(ref)
    st = b.prefix_stats
    assert st["hits"] >= 2 and st["copied_pages"] >= 1
    assert st["tokens_skipped"] >= 8 and b.pending_prefill_chunks == 0
    assert b.cache.allocator.num_free + b.cache.prefix_index_size == \
        b.cache.config.num_pages - 1


@pytest.mark.parametrize("chunk", [3, 16])
def test_chunk_sizes_match_reference(models, chunk):
    """A chunk that does not divide a page, and one wider than every
    prompt (padding rows past prompt_len), without the prefix cache."""
    _, _, _, tm, prompts, ref = models
    got = tm.generate(prompts, PLENS, NEW, page_size=PAGE, max_seqs=2,
                      harvest_every=2, prefill_chunk=chunk)
    assert got == _want(ref)


def test_int8_kv_chunked_matches_jax(models, mesh):
    _, jm, params, tm, prompts, _ = models
    got = tm.generate(prompts, PLENS, NEW, page_size=PAGE, max_seqs=2,
                      harvest_every=3, prefill_chunk=4, prefix_cache=True,
                      kv_dtype=torch.int8, kv_block=4)
    want = jm.generate(params, prompts, PLENS, NEW, mesh=mesh,
                       page_size=PAGE, max_seqs=2, harvest_every=3,
                       prefill_chunk=4, prefix_cache=True,
                       kv_dtype=jnp.int8, kv_block=4)
    assert got == [list(map(int, r)) for r in want]


def test_prefix_hit_logits_bit_identical_to_cold(models):
    """The same prompt admitted cold, then as a hit, and a whole-prompt
    full-page match (copy-on-write) against a fresh batcher's cold
    admission: the last prompt token's logits must be equal bit for
    bit."""
    _, _, _, tm, prompts, _ = models
    b = _batcher(tm)
    prompt = prompts[0, :10].tolist()

    def logits_of(batcher, uid, pr):
        batcher.run([Request(uid=uid, prompt=pr, max_new_tokens=NEW)])
        return batcher.last_prefill_logits.clone()

    cold = logits_of(b, "cold", prompt)
    hit = logits_of(b, "hit", prompt)
    assert torch.equal(cold, hit)
    assert b.prefix_stats["hits"] == 1 and b.prefix_stats["shared_pages"] == 2
    fresh = _batcher(tm)
    cow_cold = logits_of(fresh, "cc", prompt[:8])
    assert fresh.prefix_stats["hits"] == 0
    cow_hit = logits_of(b, "ch", prompt[:8])
    assert torch.equal(cow_cold, cow_hit)
    assert b.prefix_stats["copied_pages"] >= 1
    assert fresh.completions["cc"].tokens == b.completions["ch"].tokens


def test_stall_is_measured_and_progress_reports(models):
    _, _, _, tm, prompts, ref = models
    b = _batcher(tm, prefix=False)
    b.measure_stall = True
    reqs = [Request(uid=i, prompt=prompts[i, :PLENS[i]].tolist(),
                    max_new_tokens=NEW, seed=i) for i in range(6)]
    b._admit(collections.deque(reqs[:2]))
    assert b.progress() == {0: [], 1: []}
    assert b.pending_prefill_chunks == 3 + 2
    comps = b.run(reqs[2:])
    assert [comps[i].tokens for i in range(2, 6)] == _want(ref)[2:]
    assert b.decode_stall_s > 0 and 0 < b.max_prefill_stall_s <= \
        b.decode_stall_s
    assert b.prefill_chunks >= sum(-(-int(n) // 4) for n in PLENS[2:])


def test_batcher_validation_matches_jax(models):
    _, _, _, tm, _, _ = models
    b = _batcher(tm)
    fns_chunk = b.chunk_fn
    args = (b.prefill_fn, b.decode_fn, b.cache, b.pools)
    kw = dict(max_prompt_len=10)
    for bad, match in (
            (dict(chunk_fn=fns_chunk), "BOTH chunk_fn and prefill_chunk"),
            (dict(chunk_fn=fns_chunk, prefill_chunk=8),
             "prefill_chunk mismatch"),
            (dict(prefix_cache=True), "requires chunked prefill"),
            (dict(speculate_k=2), "BOTH spec_fn and speculate_k"),
            (dict(draft_source=object()), "draft_source without spec_fn")):
        with pytest.raises(ValueError, match=match):
            ContinuousBatcher(*args, **kw, **bad)
    with pytest.raises(ValueError, match="offload requires prefix_cache"):
        ContinuousBatcher(*args, **kw, offload=object())
    ccfg = dataclasses.replace(b.cache.config)
    with pytest.raises(ValueError, match="FMHA_DECODE_MAX_ROWS=512"):
        tm.decode_fns(ccfg, max_prompt_len=10, prefill_chunk=513)
    with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
        tm.decode_fns(ccfg, max_prompt_len=10, prefill_chunk=0)
