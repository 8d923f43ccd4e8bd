"""Sampled serving in the port against the JAX package's, on the CPU.

The tiny GPT of ``tests/test_torch_serving.py`` (vocab 64, 2 layers,
hidden 32, 4 heads, fp32 compute) with its leaves redrawn from a numpy
seed, converted to the port.  At temperature > 0:

- the port's ``ContinuousBatcher`` over ``decode_fns`` gives the JAX
  batcher's tokens for seeded and unseeded requests under one server key;
- a seeded request's stream depends neither on the admission order nor
  on the slot (2 or 3 slots);
- chunked prefill with the prefix cache, chain speculation (n-gram
  drafts) and tree speculation (``offramp_tree(4)``) commit the plain
  sampled stream, token for token;
- ``generate(key=)`` gives JAX's ``generate(key=)``.

Beside them, the launch-counter bookkeeping of graph replay
(``serving/graphs.py``) runs as plain Python over a stand-in for CUDA's
graph and stream calls: a replay adds what its capture counted, the
capture itself adds nothing.

``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper
(jax 0.9's vma check), as in ``tests/test_torch_serving.py``.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu._compat
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.serving import serve as jserve
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.ops import common
from apex_tpu_torch.random import PRNGKey
from apex_tpu_torch.serving import (
    ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, graphs,
    init_pools, offramp_tree,
)

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=64)
NEW = 12
PAGE = 4
MAXP = 12
K = 4


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
def setup(unchecked_shard_map):
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
    # tiled 4-cycles of ragged lengths, so n-gram drafts get accepted
    plens = [12, 11, 9, 12, 10, 8]
    prompts = []
    for n in plens:
        pat = rng.randint(1, 64, (4,))
        prompts.append([int(t) for t in np.tile(pat, 3)[:n]])
    tm = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                  device="cpu")
    tm.load_state_dict(convert.params_from_jax(params))
    yield jm, params, mesh, tm, prompts
    parallel_state.destroy_model_parallel()


def _requests(prompts, seeded, order=None):
    order = range(len(prompts)) if order is None else order
    return [Request(uid=i, prompt=prompts[i], max_new_tokens=NEW,
                    seed=(100 + i) if seeded(i) else None) for i in order]


def _ccfg(cls, slots, dtype):
    pps = -(-(MAXP + NEW + K) // PAGE)
    return cls(num_layers=2, num_heads=4, head_dim=8,
               num_pages=1 + (slots + 4) * pps, page_size=PAGE,
               max_seqs=slots, pages_per_seq=pps, dtype=dtype)


def _port(tm, slots=2, key=None, chunk=None, spec=False, tree=None,
          **sampling):
    ccfg = _ccfg(KVCacheConfig, slots, torch.float32)
    fns = tm.decode_fns(ccfg, max_prompt_len=MAXP, prefill_chunk=chunk,
                        speculate_k=K if spec else None, spec_tree=tree,
                        **sampling)
    return ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg), init_pools(ccfg, "cpu"),
        max_prompt_len=MAXP, harvest_every=3, chunk_fn=fns.chunk,
        prefill_chunk=chunk, prefix_cache=chunk is not None,
        spec_fn=fns.spec, speculate_k=K if spec else None, key=key)


def _tokens(comps):
    return {uid: c.tokens for uid, c in comps.items()}


SAMPLINGS = [dict(temperature=0.8), dict(temperature=0.7, top_k=20,
                                         top_p=0.95),
             dict(temperature=1.3, top_k=5)]


@pytest.mark.parametrize("sampling", SAMPLINGS,
                         ids=["T0.8", "T0.7-k20-p0.95", "T1.3-k5"])
def test_batcher_sampled_matches_jax(setup, sampling):
    """Seeded and unseeded requests, 6 through 2 slots, one server key:
    the port's tokens are the JAX batcher's."""
    jm, params, mesh, tm, prompts = setup
    seeded = lambda i: i % 2 == 0                       # noqa: E731
    jcfg = _ccfg(jkv.KVCacheConfig, 2, jnp.float32)
    jfns = jm.decode_fns(params, mesh, jcfg, max_prompt_len=MAXP,
                         **sampling)
    jb = jserve.ContinuousBatcher(
        jfns.prefill, jfns.decode, jkv.PagedKVCache(jcfg),
        jkv.init_pools(jcfg), max_prompt_len=MAXP, harvest_every=3,
        key=jax.random.PRNGKey(5))
    jreqs = [jserve.Request(uid=r.uid, prompt=r.prompt,
                            max_new_tokens=r.max_new_tokens, seed=r.seed)
             for r in _requests(prompts, seeded)]
    want = _tokens(jb.run(jreqs))
    got = _tokens(_port(tm, key=np.asarray(jax.random.PRNGKey(5)),
                        **sampling).run(_requests(prompts, seeded)))
    assert got == want
    greedy = _tokens(_port(tm).run(_requests(prompts, seeded)))
    assert got != greedy


@pytest.mark.parametrize("slots, order", [(2, [5, 4, 3, 2, 1, 0]),
                                          (3, [2, 0, 4, 1, 5, 3])],
                         ids=["2-slots-reversed", "3-slots-shuffled"])
def test_seeded_streams_ignore_order_and_slots(setup, slots, order):
    jm, params, mesh, tm, prompts = setup
    seeded = lambda i: True                             # noqa: E731
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    ref = _tokens(_port(tm, key=PRNGKey(1), **kw).run(
        _requests(prompts, seeded)))
    got = _tokens(_port(tm, slots=slots, key=PRNGKey(2), **kw).run(
        _requests(prompts, seeded, order)))
    assert got == ref


class _Oracle:
    """Drafts the plain sampled stream itself, wrong at every third
    position it proposes: accepted prefixes of every length, and
    rejections the correction token must repair."""

    def __init__(self, streams):
        self.streams = streams

    def draft(self, context, prompt_len):
        ref = self.streams[tuple(context[:prompt_len])]
        done = len(context) - prompt_len
        toks = list(ref[done:done + K])
        for j in range(len(toks)):
            if (done + j) % 3 == 2:
                toks[j] = (toks[j] + 1) % SIZES["vocab_size"]
        return toks, "oracle"


@pytest.mark.parametrize("mode", ["chunked-prefix", "chain", "tree"])
def test_sampled_paths_commit_the_plain_stream(setup, mode):
    """Chunked prefill with the prefix cache (prompts that share
    prefixes), chain speculation and tree speculation (drafts that follow
    the stream in part) commit the plain sampled stream."""
    jm, params, mesh, tm, prompts = setup
    prompts = prompts[:4] + [prompts[0][:9] + prompts[4][:3],
                             prompts[1][:10]]
    seeded = lambda i: i != 3                           # noqa: E731
    kw = dict(temperature=0.8, top_k=40, key=PRNGKey(7))
    ref = _tokens(_port(tm, **kw).run(_requests(prompts, seeded)))
    if mode == "chunked-prefix":
        b = _port(tm, chunk=4, **kw)
    else:
        b = _port(tm, spec=True,
                  tree=offramp_tree(K) if mode == "tree" else None, **kw)
        b.draft_source = _Oracle({tuple(prompts[i]): ref[i]
                                  for i in range(len(prompts))})
    got = _tokens(b.run(_requests(prompts, seeded)))
    assert got == ref
    if mode == "chunked-prefix":
        assert b.prefix_stats["hits"] >= 2
    else:
        st = b.spec_stats
        assert st["accepted"] > 0 and st["accepted"] < st["drafted"]
        assert st["committed"] > st["slot_steps"]


def test_generate_key_matches_jax(setup):
    jm, params, mesh, tm, prompts = setup
    arr = np.zeros((3, MAXP), np.int32)
    lens = np.array([len(p) for p in prompts[:3]], np.int32)
    for i, p in enumerate(prompts[:3]):
        arr[i, :len(p)] = p
    kw = dict(temperature=0.9, top_p=0.9)
    outs = []
    for seed in (3, 4):
        got = tm.generate(arr, lens, 8, page_size=PAGE, max_seqs=2,
                          key=np.asarray(jax.random.PRNGKey(seed)), **kw)
        want = jm.generate(params, arr, lens, 8, mesh=mesh, page_size=PAGE,
                           max_seqs=2, key=jax.random.PRNGKey(seed), **kw)
        assert got == [list(map(int, w)) for w in want]
        outs.append(got)
    assert outs[0] != outs[1]


# ------------------------------------------------ graph replay's counters
class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: the capture runs the step
    on the CPU (so the static outputs hold its values), a replay launches
    nothing."""

    def __init__(self):
        self.replays = 0

    def capture_begin(self):
        pass

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


def _fake_cuda():
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    return types.SimpleNamespace(
        current_stream=lambda device=None: stream,
        Stream=lambda device=None: stream,
        stream=lambda s: contextlib.nullcontext(),
        CUDAGraph=_FakeGraph)


def test_graph_replay_counts_launches(monkeypatch):
    """Warm-up counts its launches, the capture adds none, each replay
    adds the capture's; a replay returns the static carry, which the next
    call takes without a copy; other pools get graphs of their own beside
    the first pools' (one set a replica of a fleet), and lose them with
    the pools."""
    monkeypatch.setattr(graphs.torch, "cuda", _fake_cuda())
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, stream: None, raising=False)
    calls = []

    def step(pools, carry, table):
        common.count_launch("fake_kernel")
        common.count_launch("fake_kernel")
        common.count_launch("fake_other")
        calls.append(table.clone())
        pools["k"].add_(1.0)
        return pools, {"tokens": carry["tokens"] + table[:, 0]}, \
            carry["tokens"] * 2

    sg = graphs.StepGraph(step)
    pools = {"k": torch.zeros(3)}
    carry = {"tokens": torch.arange(4, dtype=torch.int32)}
    table = torch.ones((4, 2), dtype=torch.int32)
    common.reset_launch_counts()
    # the counts this test makes (a kernel counted by an earlier test in
    # the same process stays in the table at 0 after the reset)
    launched = lambda: {k: v for k, v in common.launch_counts().items() if v}
    _, c1, out1 = sg(pools, carry, table)
    assert launched() == {"fake_kernel": 2, "fake_other": 1}
    assert sg.captures == 1 and len(calls) == 2        # warm + capture
    assert c1["tokens"].tolist() == [1, 2, 3, 4]
    assert out1.tolist() == [0, 2, 4, 6]
    for n in range(3):
        _, c2, out2 = sg(pools, c1, table * (n + 2))
        assert launched() == {"fake_kernel": 4 + 2 * n, "fake_other": 2 + n}
        assert c2 is sg._graphs[next(iter(sg._graphs))].static_args[0]
        c1 = c2
    assert sg.replays == 3 and len(calls) == 2
    # the static inputs took the last call's table by copy
    entry = next(iter(sg._graphs.values()))
    assert entry.static_args[1].tolist() == (table * 4).tolist()
    # other pools: a fresh warm-up and capture
    other = {"k": torch.zeros(3)}
    sg(other, carry, table)
    assert sg.captures == 2 and len(calls) == 4
    assert launched() == {"fake_kernel": 10, "fake_other": 5}
    # the first pools' graph stays: a replay, no capture
    sg(pools, c1, table)
    assert sg.captures == 2 and sg.replays == 4 and len(calls) == 4
    assert len(sg._graphs) == 2
    del other
    assert len(sg._graphs) == 1
    common.reset_launch_counts()
