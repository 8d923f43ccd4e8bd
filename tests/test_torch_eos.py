"""EOS across the port's serving modes, against the JAX package.

The tiny learned-position GPT of ``tests/test_torch_speculate.py`` (vocab
64, 2 layers, hidden 32, 4 heads, fp32, weights from numpy seed 3) and its
four prompts.  For EOS ids 62, 52, 31 and 5 (62 and 52 end most streams
early, 31 one stream, 5 none) and budgets of 16, 3 and 2 new tokens, the
port's ``generate(eos_id=)`` must give, in every serving mode, what the
JAX package's paged ``generate(eos_id=)`` gives and what its
full-recompute ``generate_reference`` gives once truncated at the budget
and after the first EOS.  The modes: monolithic prefill; chunked prefill
with the prefix cache; speculation from n-gram drafts (a chain); from an
int4 ``ModelDraftSource`` of the model's own weights, as a chain and
under ``offramp_tree(4)``; and chunked prefill with speculation.  Greedy
decoding on both sides: token ids, compared exactly.

``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper
(jax 0.9's vma check), and the model-parallel state is destroyed before
and after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu._compat
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serving import KVCacheConfig
from apex_tpu_torch.serving import speculate as tspec

SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=64)
EOS = (62, 52, 31, 5)
BUDGETS = (16, 3, 2)
PAGE = 4
K = 4
MODES = ("monolithic", "chunked_prefix_cache", "ngram_chain", "int4_chain",
         "int4_offramp4", "chunked_speculation")


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
    """The four prompts of ``tests/test_torch_speculate.py`` (repetition
    in rows 0 and 2, so n-gram drafts find matches)."""
    rng = np.random.RandomState(11)
    prompts = rng.randint(1, 64, (4, 12)).astype(np.int32)
    prompts[0] = np.tile(prompts[0, :3], 4)
    prompts[2, :9] = np.tile(prompts[2, :3], 3)
    plens = np.array([12, 7, 9, 10], np.int32)
    for i in range(4):
        prompts[i, plens[i]:] = 0
    return prompts, plens


@pytest.fixture(scope="module")
def served(mesh):
    """The port's model, the prompts, the JAX reference streams (16
    tokens) and the JAX paged ``generate`` at every (EOS, budget)."""
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, compute_dtype=jnp.float32,
                                  remat=False, attention_impl="xla"))
    rng = np.random.RandomState(3)
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32),
        jm.init(jax.random.PRNGKey(0)))
    tm = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                  device="cpu")
    tm.load_state_dict(convert.params_from_jax(params))
    prompts, plens = _prompts()
    ref = np.asarray(jm.generate_reference(params, prompts, plens,
                                           max(BUDGETS), mesh=mesh))
    paged = {(eos, n): jm.generate(params, prompts, plens, n, mesh=mesh,
                                   page_size=PAGE, eos_id=eos)
             for eos in EOS for n in BUDGETS}
    return tm, prompts, plens, ref, paged


def _truncated(row, budget, eos):
    out = [int(t) for t in row[:budget]]
    return out[:out.index(eos) + 1] if eos in out else out


def _draft(tm, tree):
    dcfg = KVCacheConfig(num_layers=2, num_heads=4, head_dim=8,
                         num_pages=1 + 2 * 8, page_size=PAGE, max_seqs=2,
                         pages_per_seq=8, dtype=torch.float32)
    # weight_block=16: the qkv rows (96) tile 2 * block for int4 halves
    return tspec.ModelDraftSource(tm, dcfg, k=K, tree=tree,
                                  weight_dtype="int4", weight_block=16,
                                  ingest_chunk=4)


def _mode_options(mode, tm):
    return {
        "monolithic": lambda: {},
        "chunked_prefix_cache": lambda: dict(prefill_chunk=4,
                                             prefix_cache=True),
        "ngram_chain": lambda: dict(speculate_k=K),
        "int4_chain": lambda: dict(speculate_k=K,
                                   draft_source=_draft(tm, None)),
        "int4_offramp4": lambda: dict(
            speculate_k=K, draft_source=_draft(tm, tspec.offramp_tree(K))),
        "chunked_speculation": lambda: dict(prefill_chunk=4, speculate_k=K),
    }[mode]()


@pytest.mark.parametrize("mode", MODES)
def test_eos_matches_jax_in_every_serving_mode(served, mode):
    tm, prompts, plens, ref, paged = served
    early = 0
    for eos in EOS:
        for budget in BUDGETS:
            want = [_truncated(r, budget, eos) for r in ref]
            got = tm.generate(prompts, plens, budget, page_size=PAGE,
                              max_seqs=2, harvest_every=4, eos_id=eos,
                              **_mode_options(mode, tm))
            assert got == want, (mode, eos, budget)
            assert paged[(eos, budget)] == want, (eos, budget)
            early += sum(len(w) < budget for w in want)
    # EOS really cut streams short, at several lengths
    assert early >= 10
