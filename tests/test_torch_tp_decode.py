"""The port's tensor-parallel serving against the JAX package's tp decode
and against its own tp=1 tokens.

JAX's tp decode fails its vma check on this host (its
``tests/test_tp_decode.py`` fails there), and decode is forward only, so
its reference runs with ``apex_tpu._compat.shard_map`` swapped for a
``check=False`` wrapper (the module fixture; the swap never wraps a JAX
gradient).  The port serves in spawned ranks (gloo, one run a degree for
every case, :func:`apex_tpu_torch.testing.distributed.spawn`), each over
its head shard of the KV pools with the same page tables, gathering the
vocab-parallel logits before the sampler.  Held: greedy tokens at tp=2
and tp=4, seeded sampling with chunked prefill, the prefix cache and
chain speculation at tp=2, int8 weights at tp=2 and int4 at tp=4 (block
4), each equal to JAX's tokens at that degree and to the port's at tp=1,
the same on every rank; tree speculation (``offramp_tree(2)``, fed the
batcher's n-gram drafts) at tp=2 equal to greedy, both ranks' verify
steps over the same page tables; each rank's int8/int4 pool byte-equal
to the slice of JAX's ``quantize_gpt_weights(..., tp=)`` pool that
``_quantized_layer_specs`` gives it and to ``convert.params_from_jax(pool,
tp, rank)``, the ranks' pools joined by ``params_to_jax`` JAX's pool; the
steps' ``tp``, ``graphed`` and per-rank weight-stream bytes (JAX's
``_per_chip_param_bytes``); ``_check_quantized_tp``'s errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu._compat
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving.kv_cache import KVCacheConfig as JaxKVCacheConfig
from apex_tpu.transformer import parallel_state as jps
from apex_tpu_torch import convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.random import PRNGKey
from apex_tpu_torch.testing.distributed import spawn

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=64)
WQ_BLOCK = 4    # int4 at tp=4: qkv's 96 columns are 24 a shard
NEW = 8
SEEDED = dict(temperature=0.8, top_k=8, prefill_chunk=4, prefix_cache=True,
              speculate_k=3)
#: case -> (generate options, degrees)
CASES = {
    "greedy": ({}, (2, 4)),
    "seeded": (SEEDED, (2,)),
    "int8": (dict(weight_dtype="int8", weight_block=WQ_BLOCK), (2,)),
    "int4": (dict(weight_dtype="int4", weight_block=WQ_BLOCK), (4,)),
}


@pytest.fixture(scope="module")
def setup():
    original = apex_tpu._compat.shard_map

    def shard_map(f, mesh, in_specs, out_specs, check=True):
        return original(f, mesh, in_specs, out_specs, check=False)

    jm = JaxGPTModel(JaxGPTConfig(**SIZES, compute_dtype=jnp.float32,
                                  remat=False, attention_impl="xla"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(3)
    prompts = rng.randint(1, 64, (4, 10)).astype(np.int32)
    plens = np.array([10, 8, 6, 9], np.int32)
    for i in range(4):
        prompts[i, plens[i]:] = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(apex_tpu._compat, "shard_map", shard_map)
        yield jm, params, prompts, plens
        if jps.model_parallel_is_initialized():
            jps.destroy_model_parallel()
    assert apex_tpu._compat.shard_map is original


def _mesh(tp):
    if jps.model_parallel_is_initialized():
        jps.destroy_model_parallel()
    return jps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                         devices=jax.devices()[:tp])


def _port_kw(kw):
    kw = dict(kw)
    if "temperature" in kw:
        kw["key"] = PRNGKey(7)
    return kw


def _jax_kw(kw):
    kw = dict(kw)
    if "temperature" in kw:
        kw["key"] = jax.random.PRNGKey(7)
    return kw


def _ccfg(maxp=10):
    from apex_tpu_torch.serving import KVCacheConfig

    pps = -(-(maxp + NEW) // 4)
    return KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                         num_pages=1 + 4 * pps, page_size=4, max_seqs=2,
                         pages_per_seq=pps, dtype=torch.float32)


# ------------------------------------------------------------ the ranks

def _model(params, rank, tp):
    tm = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                  device="cpu")
    tm.load_state_dict(convert.params_from_jax(params, tp, rank))
    return tm


def _ranks(rank, params, prompts, plens):
    """Every case of this file on one rank (a spawned process)."""
    import hashlib

    from apex_tpu_torch.serving import (
        ContinuousBatcher, PagedKVCache, Request, init_pools, offramp_tree)
    from apex_tpu_torch.transformer import parallel_state as tps

    tp = tps.get_tensor_model_parallel_world_size()
    tm = _model(params, rank, tp)
    out = {"tokens": {}}
    for case, (kw, degrees) in CASES.items():
        if tp in degrees:
            out["tokens"][case] = tm.generate(prompts, plens, NEW,
                                              page_size=4, **_port_kw(kw))
    for wd in ("int8", "int4"):
        if tp not in CASES[wd][1]:
            continue
        qm = tgpt.quantize_gpt_weights(tm, wd, WQ_BLOCK)
        out[wd] = {n: t for n, t in qm.state_dict().items()
                   if n.rsplit(".", 1)[-1] in ("q8", "q4", "scales")}
        fns = tm.decode_fns(_ccfg(), max_prompt_len=10, weight_dtype=wd,
                            weight_block=WQ_BLOCK, tp=tp)
        out[wd + "_fns"] = (fns.tp, fns.decode.tp, fns.graphed,
                            fns.weight_stream_bytes)
    if tp == 2:
        # a tree verify fed chains of drafts (the greedy tokens, wrong
        # at every third step) commits the greedy stream
        ccfg = _ccfg()
        fns = tm.decode_fns(ccfg, max_prompt_len=10, speculate_k=2,
                            spec_tree=offramp_tree(2))
        pools = init_pools(ccfg, "cpu")
        out["pool_heads"] = pools["k"].shape[2]
        tables = hashlib.sha256()

        def spec(pools, carry, page_table, *args):
            tables.update(page_table.numpy().tobytes())
            return fns.spec(pools, carry, page_table, *args)

        spec.__dict__.update(fns.spec.__dict__)
        batcher = ContinuousBatcher(
            fns.prefill, fns.decode, PagedKVCache(ccfg), pools,
            max_prompt_len=10, harvest_every=2, spec_fn=spec,
            speculate_k=2)
        reqs = [Request(uid=i, prompt=[int(t) for t in prompts[i, :plens[i]]],
                        max_new_tokens=NEW) for i in range(len(plens))]
        comps = batcher.run(reqs)
        out["tree"] = [comps[i].tokens for i in range(len(plens))]
        out["table_hash"] = tables.hexdigest()
        out["verify_steps"] = batcher.spec_stats["steps"]
    return out


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    _, params, prompts, plens = setup
    return {tp: spawn(_ranks, tp, (params, prompts, plens),
                      workdir=str(tmp_path_factory.mktemp(f"tp{tp}")))
            for tp in (2, 4)}


@pytest.fixture(scope="module")
def port_tp1(setup):
    _, params, prompts, plens = setup
    tm = _model(params, 0, 1)
    return {case: tm.generate(prompts, plens, NEW, page_size=4,
                              **_port_kw(kw))
            for case, (kw, _) in CASES.items()}


CASE_IDS = [(case, tp) for case, (_, degrees) in CASES.items()
            for tp in degrees]


@pytest.mark.parametrize("case, tp", CASE_IDS,
                         ids=[f"{c}-tp{t}" for c, t in CASE_IDS])
def test_tokens_match_jax_tp_decode_and_port_tp1(setup, ranks, port_tp1,
                                                 case, tp):
    jm, params, prompts, plens = setup
    kw = CASES[case][0]
    want = jm.generate(jax.tree.map(jnp.asarray, params), prompts, plens,
                       NEW, mesh=_mesh(tp), page_size=4, **_jax_kw(kw))
    got = [o["tokens"][case] for o in ranks[tp]]
    assert got[0] == want
    assert all(g == got[0] for g in got)
    assert got[0] == port_tp1[case]


def test_tree_speculation_at_tp2_commits_greedy(ranks, port_tp1):
    outs = ranks[2]
    for o in outs:
        assert o["pool_heads"] == 2
        assert o["tree"] == port_tp1["greedy"]
        assert o["verify_steps"] > 0
    # every verify step saw the same page tables on both ranks
    assert outs[0]["table_hash"] == outs[1]["table_hash"]


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_rank_pools_are_jax_pool_slices(setup, ranks, wd):
    _, params, _, _ = setup
    tp = CASES[wd][1][0]
    pool = jgpt.quantize_gpt_weights(jax.tree.map(jnp.asarray, params), wd,
                                     WQ_BLOCK, tp=tp)
    jm = JaxGPTModel(JaxGPTConfig(**SIZES))
    specs = jgpt._quantized_layer_specs(jm.param_specs()["layers"],
                                        pool["layers"], "tp", tp)
    for r, out in enumerate(ranks[tp]):
        got = out[wd]
        n = 0
        for name, leaf in pool["layers"].items():
            for key, arr in leaf.items():
                if key not in ("q8", "q4", "scales"):
                    continue
                spec = tuple(specs[name][key])
                arr = np.asarray(arr)
                if "tp" in spec:
                    arr = np.split(arr, tp, axis=spec.index("tp"))[r]
                for layer in range(arr.shape[0]):
                    mine = got[f"layers.{layer}.{name}.{key}"].numpy()
                    assert mine.dtype == arr.dtype
                    assert mine.tobytes() == arr[layer].tobytes(), \
                        (name, key, layer)
                    n += 1
        assert n == len(got) > 0
    # the weight carry slices the JAX pool the same way, and the ranks'
    # pools gathered back are JAX's pool bit for bit
    np_pool = jax.tree.map(np.asarray, pool)
    for r, out in enumerate(ranks[tp]):
        carried = convert.params_from_jax(np_pool, tp, r)
        for name, t in out[wd].items():
            assert torch.equal(carried[name], t), name
    back = convert.params_to_jax([o[wd] for o in ranks[tp]])
    for name, leaf in back["layers"].items():
        for key, arr in leaf.items():
            assert np.asarray(arr).tobytes() == \
                np_pool["layers"][name][key].tobytes(), (name, key)


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_steps_carry_tp_and_per_rank_stream_bytes(setup, ranks, wd):
    jm, params, _, _ = setup
    tp = CASES[wd][1][0]
    ccfg = JaxKVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                            num_pages=21, page_size=4, max_seqs=2,
                            pages_per_seq=5, dtype=jnp.float32)
    fns = jm.decode_fns(jax.tree.map(jnp.asarray, params), _mesh(tp), ccfg,
                        max_prompt_len=10, weight_dtype=wd,
                        weight_block=WQ_BLOCK)
    for out in ranks[tp]:
        assert out[wd + "_fns"] == (tp, tp, False,
                                    int(fns.weight_stream_bytes))


@pytest.mark.parametrize("name, k, n, wd, block, tp", [
    ("qkv", 32, 96, "int4", 8, 4), ("fc1", 32, 128, "int8", 48, 2),
    ("fc1", 32, 130, "int8", 4, 4), ("fc2", 129, 32, "int8", 4, 2),
    ("fc2", 128, 32, "int4", 4, 2)])
def test_quantized_tp_errors_are_jax_s(name, k, n, wd, block, tp):
    def err(fn):
        try:
            fn(name, k, n, wd, block, tp)
        except ValueError as e:
            return str(e)
        return None

    assert err(tgpt._check_quantized_tp) == err(jgpt._check_quantized_tp)
