"""Serving at the fp16 opt levels O1-O3 in the port, against the JAX package.

The tiny model of ``tests/test_torch_gpt_fp16.py`` (2 layers, hidden 64, 2
heads of 32, vocab 256) at O1 (fp32 parameters, fp16 compute), O2 (fp16
parameters, fp32 norms) and O3 (all fp16).  The JAX model's parameter tree
at each level gives the structure and the dtypes; every leaf is redrawn
from a numpy seed (std 0.2, the norms' gains 1 + 0.1 N(0, 1): with gains
of std 0.2 about 0 the greedy streams repeat one or two tokens) and feeds
both packages, the port's through ``convert.params_from_jax``.  The JAX side
runs its XLA attention and its serving steps under a 1-device
``shard_map``; the port runs its kernels' plain versions on CPU tensors.

What is held, per level:

- one step each of ``decode_step``, ``prefill_chunk`` and ``verify_step``
  (a chain and ``offramp_tree(4)``) on the same random pools, fp16 or int8
  pages: logits within 1% of their norm, and the written fp16 K/V rows
  within 1% of their norm (int8 values within one quantization step);
  ``prefill_forward``'s logits and K/V the same;
- greedy streams: the port's monolithic, chunked + prefix-cached, chain
  (n-gram drafts) and tree (``offramp_tree(4)`` from an int4
  ``ModelDraftSource``) serving, and its full recompute, against JAX's
  full recompute ``generate_reference``; int8 and int4 weight pools and
  int8 KV pages against JAX's paged ``generate`` at the same widths; the
  O1 + ``weight_dtype="bf16"`` promotion against JAX's.  Tokens must be
  equal; a first divergence is allowed only where JAX's top-two logit
  margin at that position (its recompute on the same weights) is under
  :data:`MARGIN_SHARE` of the logit scale (fp16 logits differ by rounding
  order, about 2**-11 relative a rounding; at these seeds O3's int8
  weights diverge on a margin of 0.03% of the scale, its int8 KV pages on
  0.15%, every other stream not at all);
- sampled streams (T 0.8, top-k 40, top-p 0.95, one key) equal to JAX's;
- a prefix hit's logits bit-identical to a cold prefill's.

And the plain versions at fp16: the paged decode's against
``_decode_kernel`` (``implementation="pallas"``, interpret mode) and the
dequant pair's against ``_int8_kernel`` / ``_int4_kernel``: both sum in
fp32 and round once to fp16, so no output may be more than one fp16 ulp
off and under 1% differ at all (the sums' order differs; an output that
cancels below the sums' rounding error, sqrt(k) 2**-24 sum |x_i w_i|, has
its ulp taken at that error).

Tolerances are PR 19's fp16 bands (1% of a norm) or tighter.
``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper
(jax 0.9's vma check rejects these steps), and the model-parallel state is
destroyed before and after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu._compat
from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models.gpt import QUANTIZED_WEIGHT_LEAVES
from apex_tpu.models.gpt import (
    quantize_gpt_weights as jax_quantize_gpt_weights,
)
from apex_tpu.ops.attention import flash_attention as jax_flash_attention
from apex_tpu.ops.attention_decode import fmha_decode as jax_fmha_decode
from apex_tpu.ops.dequant_matmul import dequant_matmul as jax_dequant_matmul
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import speculate as jspec
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import amp, convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.ops import attention_decode as port_decode
from apex_tpu_torch.ops import flash_attention
from apex_tpu_torch.ops.dequant_matmul import (
    _dequantized, dequant_matmul, quantize_weight,
)
from apex_tpu_torch.random import PRNGKey
from apex_tpu_torch.serving import (
    ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools,
    kv_cache as tkv, speculate as tspec,
)

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=2, max_position_embeddings=128)
LEVELS = ("O1", "O2", "O3")
HEADS, HEAD_DIM = 2, 32
PAGE = 8
NEW = 10
K = 4
#: four ragged prompts: row 2 is row 0's first page (a page-aligned
#: whole-prompt match: copy-on-write), row 3 extends row 0's first page
PLENS = np.array([14, 11, 8, 13], np.int32)
#: a first divergence of two greedy streams is allowed only where the
#: reference's top-two logits lie closer than this share of the logit
#: scale (the 1% band of the logits)
MARGIN_SHARE = 0.01
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)


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
    rng = np.random.RandomState(5)
    prompts = rng.randint(1, 256, (4, 14)).astype(np.int32)
    prompts[2, :PAGE] = prompts[0, :PAGE]
    prompts[3, :PAGE] = prompts[0, :PAGE]
    for i, n in enumerate(PLENS):
        prompts[i, n:] = 0
    return prompts


def _build(level, mesh, seed=31):
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, policy=jamp.get_policy(level),
                                  remat=False, attention_impl="xla"))
    tm = GPTModel(GPTConfig(**SIZES, policy=amp.get_policy(level)),
                  device="cpu")
    rng = np.random.RandomState(seed)

    def draw(path, x):
        names = "/".join(str(getattr(e, "key", e)) for e in path)
        r = rng.randn(*x.shape)
        if "ln" in names and names.endswith("scale"):
            r = 1.0 + 0.1 * r                # a norm's gain, near 1
        else:
            r = 0.2 * r
        return r.astype(np.float32).astype(x.dtype)

    params = jax.tree_util.tree_map_with_path(
        draw, jm.init(jax.random.PRNGKey(0)))
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, params, tm


@pytest.fixture(scope="module", params=LEVELS)
def models(request, mesh):
    """``(level, jm, params, tm, prompts, ref)``: ``ref`` is JAX's full
    recompute greedy stream (``generate_reference``) at the level."""
    jm, params, tm = _build(request.param, mesh)
    prompts = _prompts()
    ref = np.asarray(jm.generate_reference(params, prompts, PLENS, NEW,
                                           mesh=mesh))
    return request.param, jm, params, tm, prompts, ref


def _shard(mesh, f, n_in, n_out):
    return jax.jit(apex_tpu._compat.shard_map(
        f, mesh=mesh, in_specs=(P(),) * n_in,
        out_specs=P() if n_out == 1 else (P(),) * n_out))


def _close(got, want, share=0.01, name=""):
    """``got`` within ``share`` of ``want``'s norm (fp32 arithmetic)."""
    g = torch.as_tensor(np.asarray(got, np.float32))
    w = torch.as_tensor(np.asarray(want, np.float32))
    assert torch.isfinite(g).all() and torch.isfinite(w).all(), name
    assert (g - w).norm() <= share * w.norm() + 1e-6, (
        name, float((g - w).norm()), float(w.norm()))


def _pools_match(got, want):
    for name, w in want.items():
        g, w = got[name].float().numpy() if got[name].dtype != torch.int8 \
            else got[name].numpy(), np.asarray(w)
        if w.dtype == np.int8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
        else:
            assert got[name].dtype == _torch_dtype(w.dtype), name
            _close(g, w.astype(np.float32), name=name)


def _torch_dtype(np_dtype):
    return {np.dtype(np.float16): torch.float16,
            np.dtype(np.float32): torch.float32}[np.dtype(np_dtype)]


def _pools(kv_int8, seed, pages=24):
    """Random pool contents (numpy), fed to both sides: 2 layers of
    ``pages`` pages (2 heads, 8 tokens, 32 dims), int8 with ``kv_block``
    16 scales or fp16."""
    rng = np.random.RandomState(seed)
    shape = (2, pages, HEADS, PAGE, HEAD_DIM)
    if kv_int8:
        arrays = {n: rng.randint(-127, 128, shape).astype(np.int8)
                  for n in ("k", "v")}
        arrays.update({n: rng.uniform(0.01, 0.05, shape[:-1] + (2,))
                       .astype(np.float32) for n in ("k_scales", "v_scales")})
    else:
        arrays = {n: rng.randn(*shape).astype(np.float16)
                  for n in ("k", "v")}
    return arrays


def _jpools(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _tpools(arrays):
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def _want(ref):
    return [list(map(int, r)) for r in ref]


def _margin(jm, params, mesh, context):
    """JAX's top-two logit margin and logit scale after ``context``."""
    f = _shard(mesh, lambda p, t: jm.apply(p, t), 2, 1)
    row = np.asarray(f(params, jnp.asarray([context], jnp.int32)),
                     np.float32)[0, -1]
    top = np.sort(row)[-2:]
    return float(top[1] - top[0]), float(np.abs(row).max())


def _same_stream(jm, params, mesh, prompts, got, want, what):
    """Tokens equal, or equal up to a first divergence where JAX's top
    two logits lie within :data:`MARGIN_SHARE` of the logit scale."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        t = next(j for j in range(len(w)) if j >= len(g) or g[j] != w[j])
        context = prompts[i, :PLENS[i]].tolist() + w[:t]
        margin, scale = _margin(jm, params, mesh, context)
        assert margin < MARGIN_SHARE * scale, (
            what, i, t, g, w, margin, scale)


# --------------------------------------------------------------- one step
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp16kv", "int8kv"])
def test_decode_step_matches_jax(models, mesh, kv_int8):
    level, jm, params, tm, _, _ = models
    arrays = _pools(kv_int8, seed=3 + kv_int8)
    rng = np.random.RandomState(8)
    table = rng.permutation(np.arange(1, 24))[:18].reshape(3, 6).astype(
        np.int32)
    tokens = rng.randint(1, 256, 3).astype(np.int32)
    positions = np.array([5, 17, 40], np.int32)
    active = np.array([True, True, False])
    kw = dict(quantized=kv_int8, kv_block=16)
    f = _shard(mesh, lambda p, pools, t, pos, a, tb: jm.decode_step(
        p, t, pos, a, tb, pools, **kw), 6, 2)
    jl, jpools = f(params, _jpools(arrays), *(jnp.asarray(x) for x in (
        tokens, positions, active, table)))
    with torch.no_grad():
        tl, tpools = tm.decode_step(*(torch.from_numpy(x) for x in (
            tokens, positions, active, table)), _tpools(arrays), **kw)
    assert tl.dtype == torch.float16 and jl.dtype == jnp.float16
    _close(tl[:2], np.asarray(jl)[:2], name=f"{level} logits")
    _pools_match(tpools, jpools)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp16kv", "int8kv"])
@pytest.mark.parametrize("C, start, plen, wf", [(8, 0, 13, 0),
                                                (8, 8, 13, 10)])
def test_prefill_chunk_matches_jax(models, mesh, kv_int8, C, start, plen,
                                   wf):
    level, jm, params, tm, _, _ = models
    arrays = _pools(kv_int8, seed=C + start + kv_int8)
    row = np.random.RandomState(7).permutation(np.arange(1, 24))[:4].astype(
        np.int32)
    toks = np.random.RandomState(C + start).randint(1, 256, (1, C)).astype(
        np.int32)
    kw = dict(quantized=kv_int8, kv_block=16)
    f = _shard(mesh, lambda p, pools, t, r: jm.prefill_chunk(
        p, t, start, plen, wf, r, pools, **kw), 4, 2)
    jl, jpools = f(params, _jpools(arrays), jnp.asarray(toks),
                   jnp.asarray(row))
    with torch.no_grad():
        tl, tpools = tm.prefill_chunk(torch.from_numpy(toks), start, plen, wf,
                                      torch.from_numpy(row), _tpools(arrays),
                                      **kw)
    assert tl.dtype == torch.float16
    _close(tl, np.asarray(jl), name=f"{level} chunk logits")
    _pools_match(tpools, jpools)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp16kv", "int8kv"])
@pytest.mark.parametrize("tree", [None, jspec.offramp_tree(K)],
                         ids=["chain", "offramp4"])
def test_verify_step_matches_jax(models, mesh, tree, kv_int8):
    level, jm, params, tm, _, _ = models
    arrays = _pools(kv_int8, seed=11 + kv_int8)
    rng = np.random.RandomState(12)
    S, R = 3, (K + 1 if tree is None else len(tree))
    table = rng.permutation(np.arange(1, 24))[:S * 6].reshape(S, 6).astype(
        np.int32)
    lengths = np.array([5, 21, 44], np.int32)
    tokens = rng.randint(1, 256, (S, R)).astype(np.int32)
    valid = np.ones((S, R), bool)
    valid[0, 3:] = False
    active = np.array([True, True, True])
    kw = dict(quantized=kv_int8, kv_block=16, tree=tree)
    n_out = 2 if tree is None else 3
    f = _shard(mesh, lambda p, pools, t, ln, a, v, tb: jm.verify_step(
        p, t, ln, a, v, tb, pools, **kw), 7, n_out)
    want = f(params, _jpools(arrays), *(jnp.asarray(x) for x in (
        tokens, lengths, active, valid, table)))
    with torch.no_grad():
        got = tm.verify_step(*(torch.from_numpy(x) for x in (
            tokens, lengths, active, valid, table)), _tpools(arrays), **kw)
    _close(got[0], np.asarray(want[0]), name=f"{level} verify logits")
    _pools_match(got[1], want[1])
    if tree is not None:
        for g, w in zip(got[2], want[2]):
            _close(g, np.asarray(w), name=f"{level} stashed K/V")


def test_prefill_forward_matches_jax(models, mesh):
    level, jm, params, tm, prompts, _ = models
    toks = prompts[:1]
    f = _shard(mesh, lambda p, t: (lambda h, k, v: (
        jm.logits(p, h), k, v))(*jm.prefill_forward(p, t)), 2, 3)
    want = f(params, jnp.asarray(toks))
    with torch.no_grad():
        h, k, v = tm.prefill_forward(torch.from_numpy(toks))
        got = (tm.logits(h), k, v)
    for g, w, name in zip(got, want, ("logits", "k", "v")):
        assert g.dtype == torch.float16, name
        _close(g, np.asarray(w), name=f"{level} prefill {name}")


# ---------------------------------------------------------------- streams
def _batcher(tm, chunk=None, prefix=False, slots=2, kv_dtype=None):
    pps = -(-(14 + NEW + K) // PAGE)
    ccfg = KVCacheConfig(num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM,
                         num_pages=1 + (slots + 4) * pps, page_size=PAGE,
                         max_seqs=slots, pages_per_seq=pps,
                         dtype=torch.float16, kv_dtype=kv_dtype,
                         kv_block=16)
    fns = tm.decode_fns(ccfg, max_prompt_len=14, prefill_chunk=chunk)
    return ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg), init_pools(ccfg, "cpu"),
        max_prompt_len=14, harvest_every=3, chunk_fn=fns.chunk,
        prefill_chunk=chunk, prefix_cache=prefix)


def test_reference_streams_are_not_degenerate(models):
    *_, ref = models
    assert len({tuple(r) for r in ref}) == 4
    assert all(len(set(r)) > 2 for r in ref)


def test_port_reference_matches_jax(models, mesh):
    level, jm, params, tm, prompts, ref = models
    got = tm.generate_reference(prompts, PLENS, NEW)
    _same_stream(jm, params, mesh, prompts, _want(got), _want(ref),
                 f"{level} recompute")


@pytest.mark.parametrize("mode", ["monolithic", "chunked+prefix", "batcher",
                                  "ngram", "tree+int4draft"])
def test_greedy_serving_matches_jax_reference(models, mesh, mode):
    """Every serving mode's greedy stream against JAX's full recompute."""
    level, jm, params, tm, prompts, ref = models
    kw = dict(page_size=PAGE, max_seqs=2, harvest_every=3)
    if mode == "monolithic":
        got = tm.generate(prompts, PLENS, NEW, **kw)
    elif mode == "chunked+prefix":
        got = tm.generate(prompts, PLENS, NEW, prefill_chunk=4,
                          prefix_cache=True, **kw)
    elif mode == "batcher":
        b = _batcher(tm, chunk=4, prefix=True)
        comps = b.run([Request(uid=i, prompt=prompts[i, :n].tolist(),
                               max_new_tokens=NEW)
                       for i, n in enumerate(PLENS)])
        got = [comps[i].tokens for i in range(4)]
        assert b.prefix_stats["hits"] >= 2
        assert b.prefix_stats["copied_pages"] >= 1
    elif mode == "ngram":
        got = tm.generate(prompts, PLENS, NEW, speculate_k=K, **kw)
    else:
        dcfg = KVCacheConfig(num_layers=2, num_heads=HEADS,
                             head_dim=HEAD_DIM, num_pages=1 + 2 * 8,
                             page_size=PAGE, max_seqs=2, pages_per_seq=8,
                             dtype=torch.float16)
        # weight_block 32: every projection's n tiles 2 * block (int4)
        draft = tspec.ModelDraftSource(tm, dcfg, k=K,
                                       tree=tspec.offramp_tree(K),
                                       weight_dtype="int4", weight_block=32,
                                       ingest_chunk=4)
        got = tm.generate(prompts, PLENS, NEW, speculate_k=K,
                          draft_source=draft, **kw)
    _same_stream(jm, params, mesh, prompts, got, _want(ref),
                 f"{level} {mode}")


@pytest.mark.parametrize("width", ["int8", "int4", "int8kv"])
def test_quantized_serving_matches_jax(models, mesh, width):
    """int8/int4 weight pools and int8 KV pages: the port's greedy stream
    against JAX's paged ``generate`` at the same width, a first divergence
    only under the margin of JAX's recompute on the same weight pools
    (int8 KV: on the full-precision weights; the pages' rounding moves the
    logits by up to 2% of their scale at fp32, chip_smoke's quant-parity,
    so such a divergence sits on a near tie)."""
    level, jm, params, tm, prompts, _ = models
    kw = dict(page_size=PAGE, max_seqs=2, harvest_every=3)
    if width == "int8kv":
        got = tm.generate(prompts, PLENS, NEW, kv_dtype=torch.int8,
                          kv_block=16, **kw)
        want = jm.generate(params, prompts, PLENS, NEW, mesh=mesh,
                           kv_dtype=jnp.int8, kv_block=16, **kw)
        oracle = params
    else:
        got = tm.generate(prompts, PLENS, NEW, weight_dtype=width,
                          weight_block=32, **kw)
        want = jm.generate(params, prompts, PLENS, NEW, mesh=mesh,
                           weight_dtype=width, weight_block=32, **kw)
        oracle = jax_quantize_gpt_weights(params, width, 32)
    want = _want(want)
    assert len({tuple(w) for w in want}) >= 3
    _same_stream(jm, oracle, mesh, prompts, got, want, f"{level} {width}")


def test_sampled_streams_match_jax(models, mesh):
    level, jm, params, tm, prompts, _ = models
    kw = dict(page_size=PAGE, max_seqs=2, harvest_every=3, **SAMPLED)
    got = tm.generate(prompts, PLENS, NEW, key=np.asarray(
        jax.random.PRNGKey(11)), **kw)
    want = jm.generate(params, prompts, PLENS, NEW, mesh=mesh,
                       key=jax.random.PRNGKey(11), **kw)
    assert got == _want(want)
    greedy = tm.generate(prompts, PLENS, NEW, page_size=PAGE, max_seqs=2)
    assert got != greedy
    assert tm.generate(prompts, PLENS, NEW, key=PRNGKey(11), **kw) == got


def test_prefix_hit_logits_bit_identical_to_cold(models):
    level, _, _, tm, prompts, _ = models
    b = _batcher(tm, chunk=4, prefix=True)
    prompt = prompts[0, :PLENS[0]].tolist()

    def logits_of(batcher, uid, pr):
        batcher.run([Request(uid=uid, prompt=pr, max_new_tokens=2)])
        return batcher.last_prefill_logits.clone()

    cold = logits_of(b, "cold", prompt)
    hit = logits_of(b, "hit", prompt)
    assert cold.dtype == torch.float16
    assert torch.equal(cold, hit)
    fresh = _batcher(tm, chunk=4, prefix=True)
    assert torch.equal(logits_of(fresh, "cc", prompt[:PAGE]),
                       logits_of(b, "ch", prompt[:PAGE]))
    assert b.prefix_stats["copied_pages"] >= 1


# ------------------------------------------------- widths and promotion
def test_weight_widths_are_named_as_jax(models):
    level, jm, params, tm, _, _ = models
    want = jm._weight_pool_dtype(params)
    assert tm._weight_pool_dtype() == want == (
        "float32" if level == "O1" else "float16")
    tm._check_weight_dtype(want)
    with pytest.raises(ValueError, match="declared"):
        tm._check_weight_dtype("bf16")
    ccfg = KVCacheConfig(num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM,
                         num_pages=9, page_size=PAGE, max_seqs=2,
                         pages_per_seq=4, dtype=torch.float16)
    assert tm.decode_fns(ccfg, max_prompt_len=14).weight_dtype == want
    with pytest.raises(ValueError, match="query's dtype"):
        tm.decode_fns(KVCacheConfig(
            num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM, num_pages=9,
            page_size=PAGE, max_seqs=2, pages_per_seq=4,
            dtype=torch.bfloat16), max_prompt_len=14)


def test_o1_bf16_weight_copies_promote_as_jax(mesh):
    """O1 (fp32 parameters, fp16 compute) served with
    ``weight_dtype="bf16"``: both packages keep bf16 copies of the five
    projections and each step casts them to the fp16 activations
    (``weight.astype(x.dtype)``): one decode step's logits and the greedy
    stream against JAX's."""
    jm, params, tm = _build("O1", mesh)
    prompts = _prompts()
    ccfg = KVCacheConfig(num_layers=2, num_heads=HEADS, head_dim=HEAD_DIM,
                         num_pages=25, page_size=PAGE, max_seqs=3,
                         pages_per_seq=6, dtype=torch.float16)
    fns = tm.decode_fns(ccfg, max_prompt_len=14, weight_dtype="bf16")
    assert fns.weight_dtype == "bf16"
    assert tm._weight_pool_dtype() == "float32"
    # JAX's conversion (apex_tpu/models/gpt.py decode_fns): the
    # projections' weights to bf16, everything else as it is
    layers = dict(params["layers"])
    for name in QUANTIZED_WEIGHT_LEAVES:
        if name in layers:
            layers[name] = dict(layers[name], weight=np.asarray(
                layers[name]["weight"]).astype(jnp.bfloat16))
    bparams = dict(params, layers=layers)
    arrays = _pools(False, seed=21)
    rng = np.random.RandomState(22)
    table = rng.permutation(np.arange(1, 24))[:18].reshape(3, 6).astype(
        np.int32)
    tokens = rng.randint(1, 256, 3).astype(np.int32)
    positions = np.array([3, 9, 30], np.int32)
    active = np.ones(3, bool)
    f = _shard(mesh, lambda p, pools, t, pos, a, tb: jm.decode_step(
        p, t, pos, a, tb, pools, weight_dtype="bf16"), 6, 2)
    jl, _ = f(bparams, _jpools(arrays), *(jnp.asarray(x) for x in (
        tokens, positions, active, table)))
    from apex_tpu_torch.models.gpt import _bf16_projections
    bm = _bf16_projections(tm)
    assert bm.layers[0].qkv.weight.dtype == torch.bfloat16
    with torch.no_grad():
        tl, _ = bm.decode_step(*(torch.from_numpy(x) for x in (
            tokens, positions, active, table)), _tpools(arrays),
            weight_dtype="bf16")
    assert tl.dtype == torch.float16
    _close(tl, np.asarray(jl), name="O1 bf16 copies")
    # the copies are not the fp32 weights: the logits move
    with torch.no_grad():
        fl, _ = tm.decode_step(*(torch.from_numpy(x) for x in (
            tokens, positions, active, table)), _tpools(arrays))
    assert not torch.equal(fl, tl)
    got = tm.generate(prompts, PLENS, NEW, page_size=PAGE, max_seqs=2,
                      weight_dtype="bf16")
    want = jm.generate(params, prompts, PLENS, NEW, mesh=mesh,
                       page_size=PAGE, max_seqs=2, weight_dtype="bf16")
    assert got == _want(want)


def test_int8_pages_quantized_from_fp16_rows_as_jax():
    """``write_tokens(quantized=True)`` over fp16 K/V rows: the int8
    values and fp32 scales JAX's writer makes (values within one step)."""
    rng = np.random.RandomState(13)
    shape = (6, HEADS, PAGE, HEAD_DIM)
    base = {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
            "k_scales": np.ones(shape[:-1] + (2,), np.float32),
            "v_scales": np.ones(shape[:-1] + (2,), np.float32)}
    k_new = (2 * rng.randn(5, HEADS, HEAD_DIM)).astype(np.float16)
    v_new = rng.randn(5, HEADS, HEAD_DIM).astype(np.float16)
    pages = np.array([1, 1, 3, 0, 5], np.int32)
    offsets = np.array([0, 7, 2, 0, 4], np.int32)
    want = jkv.write_tokens(_jpools(base), jnp.asarray(k_new),
                            jnp.asarray(v_new), jnp.asarray(pages),
                            jnp.asarray(offsets), quantized=True, kv_block=16)
    got = tkv.write_tokens(_tpools(base), torch.from_numpy(k_new),
                           torch.from_numpy(v_new), torch.from_numpy(pages),
                           torch.from_numpy(offsets), quantized=True,
                           kv_block=16)
    for name in ("k", "v"):
        g, w = got[name].numpy().astype(int), np.asarray(want[name]).astype(
            int)
        assert np.abs(g - w).max() <= 1, name
    for name in ("k_scales", "v_scales"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6)


# -------------------------------------------------------- plain versions
def _ulps_off(got, want, noise=0.0):
    """Largest distance in fp16 ulps at each element of ``want``, the ulp
    never taken below ``noise``."""
    g, w = got.astype(np.float32), want.astype(np.float32)
    ulp = np.maximum(np.exp2(np.floor(np.log2(np.maximum(
        np.abs(w), 2.0 ** -14))) - 10), noise)
    return float(np.max(np.where(g == w, 0.0, np.abs(g - w) / ulp)))


def _decode_layout(sq, seed, int8=False):
    rng = np.random.RandomState(seed)
    pps = 9
    lengths = np.array([0, max(sq, 5), 2 * PAGE + 3, 5 * PAGE + 7], np.int32)
    num_pages = 1 + int(sum(-(-n // PAGE) for n in lengths))
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((4, pps), np.int32)
    at = 0
    for b, n in enumerate(lengths):
        used = -(-int(n) // PAGE)
        table[b, :used] = perm[at:at + used]
        at += used
    shape = (num_pages, HEADS, PAGE, HEAD_DIM)
    if int8:
        k = rng.randint(-127, 128, shape).astype(np.int8)
        v = rng.randint(-127, 128, shape).astype(np.int8)
        scales = [rng.uniform(0.005, 0.02, shape[:-1] + (2,)).astype(
            np.float32) for _ in range(2)]
    else:
        k = rng.randn(*shape).astype(np.float16)
        v = rng.randn(*shape).astype(np.float16)
        scales = [None, None]
    q = rng.randn(4, HEADS, sq, HEAD_DIM).astype(np.float16)
    return q, k, v, table, lengths, scales


@pytest.mark.parametrize("case", ["sq1", "sq4", "sq4 not causal",
                                  "int8 pages", "rope", "tree", "rows 24"])
def test_plain_decode_matches_pallas_fp16(case):
    sq = {"sq1": 1, "tree": 9, "rows 24": 24}.get(case, 4)
    q, k, v, table, lengths, (ks, vs) = _decode_layout(
        sq, seed=len(case), int8=case == "int8 pages")
    causal = case != "sq4 not causal"
    kw = {}
    if ks is not None:
        kw = dict(k_scales=ks, v_scales=vs, kv_block=16)
    if case == "rope":
        rng = np.random.RandomState(3)
        ang = rng.uniform(0, 6, (4, sq, HEAD_DIM // 2)).astype(np.float32)
        kw = dict(rope=(np.cos(ang), np.sin(ang)))
    if case == "tree":
        kw = dict(ancestor=jspec.tree_ancestors(jspec.offramp_tree(K)))
    jkw = {n: (tuple(jnp.asarray(t) for t in x) if n == "rope" else
               x if n in ("ancestor", "kv_block") else jnp.asarray(x))
           for n, x in kw.items()}
    tkw = {n: (tuple(torch.from_numpy(t) for t in x) if n == "rope" else
               x if n in ("ancestor", "kv_block") else torch.from_numpy(x))
           for n, x in kw.items()}
    want = np.asarray(jax_fmha_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), causal=causal, implementation="pallas", **jkw))
    got = port_decode.fmha_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lengths), causal=causal,
        **tkw)
    assert got.dtype == torch.float16 and want.dtype == np.float16
    assert np.isfinite(want).all()
    # the idle slot's row is a finite zero on both sides
    assert not got[0].float().abs().max() and not np.abs(want[0]).max()
    assert _ulps_off(got.numpy(), want) <= 1.0, case


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
@pytest.mark.parametrize("m", [4, 40])
def test_plain_dequant_matches_pallas_fp16(weight_dtype, m):
    rng = np.random.RandomState(m)
    w = (0.02 * rng.randn(256, 512)).astype(np.float32)
    pool = quantize_weight(torch.from_numpy(w), weight_dtype, 64)
    q = pool["q8" if weight_dtype == "int8" else "q4"]
    x = rng.randn(m, 256).astype(np.float16)
    want = np.asarray(jax_dequant_matmul(
        jnp.asarray(x), jnp.asarray(q.numpy()), jnp.asarray(
            pool["scales"].numpy()), weight_dtype=weight_dtype,
        implementation="pallas"))
    got = dequant_matmul(torch.from_numpy(x), q, pool["scales"],
                         weight_dtype=weight_dtype)
    assert got.dtype == torch.float16 and want.dtype == np.float16
    # an output that cancels below the fp32 sums' rounding error,
    # sqrt(k) 2**-24 sum |x_i w_i|, differs by more than its fp16 ulp
    # between the two orders of summation
    wide = _dequantized(q, pool["scales"], weight_dtype, 64)
    noise = 256 ** 0.5 * 2.0 ** -24 * (np.abs(x.astype(np.float32))
                                       @ np.abs(wide.numpy()))
    assert _ulps_off(got.numpy(), want, noise) <= 1.0
    assert np.mean(got.numpy() != want) < 0.01


def test_flash_attention_decode_rung_at_fp16():
    """``flash_attention(implementation="decode")`` in fp16 against
    JAX's: the contiguous K/V viewed as pages, the decode plain version."""
    rng = np.random.RandomState(17)
    q = rng.randn(2, HEADS, 3, HEAD_DIM).astype(np.float16)
    k = rng.randn(2, HEADS, 40, HEAD_DIM).astype(np.float16)
    v = rng.randn(2, HEADS, 40, HEAD_DIM).astype(np.float16)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        implementation="decode"))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True,
                          implementation="decode")
    assert got.dtype == torch.float16
    assert _ulps_off(got.numpy(), want) <= 1.0
