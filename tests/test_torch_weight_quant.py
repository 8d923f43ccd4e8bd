"""Quantized weight pools in the port's GPT against the JAX package's.

Two tiny models, their leaves redrawn from a numpy seed (std 0.2, so that
greedy streams vary) and fed to both packages: the flagship layout (vocab
64, 2 layers, hidden 32, 4 heads) and the Llama mode (vocab 256, 2
layers, hidden 64, 2 heads, rope, RMSNorm, SwiGLU: the ``fc_gate`` leaf).
Block size 16, which tiles every projection at both widths.

- ``quantize_gpt_weights`` gives the JAX package's pools bit for bit, and
  a JAX quantized tree loads into the port's quantized model strictly
  and crosses back unchanged;
- ``decode_fns`` stamps the same width and weight-stream bytes as JAX's,
  and refuses a mismatched width;
- greedy tokens from int8 and int4 pools through ``ContinuousBatcher``
  (6 requests, 2 slots) equal JAX ``decode_fns(weight_dtype=)`` with its
  own batcher, quantized inside ``decode_fns`` or beforehand.  Token
  identity, no tolerance: at fp32 compute both dequantize to the same
  weights and their logits agree to about 1e-6, far inside the gaps
  between the top two logits here.

JAX's serving steps are wrapped in ``apex_tpu._compat.shard_map`` with
the vma check on, which jax 0.9 rejects for this model; a module-scoped
fixture swaps in a ``check=False`` wrapper and restores the original.
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
from apex_tpu.models.gpt import quantize_gpt_weights as jax_quantize
from apex_tpu.serving import kv_cache as jax_kv
from apex_tpu.serving import serve as jax_serve
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.models.gpt import quantize_gpt_weights
from apex_tpu_torch.serving import (
    ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools,
)
from apex_tpu_torch.transformer.tensor_parallel import QuantizedLinear

torch.set_num_threads(1)  # the suite's parallel workers share the cores

FLAGSHIP = dict(vocab_size=64, num_layers=2, hidden_size=32,
                num_attention_heads=4, max_position_embeddings=64)
LLAMA = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=2, max_position_embeddings=64,
             position_embedding="rope", activation="swiglu",
             normalization="rmsnorm")
MODELS = {"flagship": FLAGSHIP, "llama": LLAMA}
BLOCK = 16
NEW = 10
PAGE = 4


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


def models(kind, seed=4):
    sizes = MODELS[kind]
    jm = JaxGPTModel(JaxGPTConfig(**sizes, compute_dtype=jnp.float32,
                                  remat=False, attention_impl="xla"))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32),
        jm.init(jax.random.PRNGKey(0)))
    tm = GPTModel(GPTConfig(**sizes, compute_dtype=torch.float32),
                  device="cpu")
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, tm, params


def _leaves(tree):
    return dict(convert._flatten(jax.tree.map(np.asarray, tree)))


def _same_tree(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=str(key))


@pytest.mark.parametrize("kind", ["flagship", "llama"])
@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantize_gpt_weights_bit_identical_to_jax(kind, weight_dtype):
    _, tm, params = models(kind)
    qm = quantize_gpt_weights(tm, weight_dtype, BLOCK)
    _same_tree(convert.params_to_jax(qm.state_dict()),
               jax_quantize(params, weight_dtype, BLOCK))
    # the model it came from is untouched; the rest is shared, not copied
    assert not isinstance(tm.layers[0].qkv, QuantizedLinear)
    assert isinstance(qm.layers[1].fc2, QuantizedLinear)
    assert qm.embedding.weight is tm.embedding.weight
    assert qm.layers[0].ln1.scale is tm.layers[0].ln1.scale
    if kind == "llama":
        assert qm.layers[0].fc_gate.weight_dtype == weight_dtype


@pytest.mark.parametrize("kind", ["flagship", "llama"])
@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_jax_quantized_tree_loads_strictly_and_round_trips(kind,
                                                           weight_dtype):
    """A JAX pool (int8 ``q8``/``q4``, fp32 ``scales``) crosses the weight
    bridge bit for bit, into a quantized port model built from other
    weights, with no missing or unexpected key."""
    _, _, params = models(kind)
    jq = jax.tree.map(np.asarray, jax_quantize(params, weight_dtype, BLOCK))
    _, other, _ = models(kind, seed=11)
    qm = quantize_gpt_weights(other, weight_dtype, BLOCK)
    state = convert.params_from_jax(jq)
    assert state["layers.1.qkv." + ("q8" if weight_dtype == "int8"
                                     else "q4")].dtype == torch.int8
    result = qm.load_state_dict(state, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    _same_tree(convert.params_to_jax(qm.state_dict()), jq)


def _ccfg(jax_side, sizes=FLAGSHIP, kv_dtype=None, max_seqs=2):
    pps = -(-(10 + NEW) // PAGE)
    heads = sizes["num_attention_heads"]
    kw = dict(num_layers=2, num_heads=heads,
              head_dim=sizes["hidden_size"] // heads,
              num_pages=1 + max_seqs * pps, page_size=PAGE,
              max_seqs=max_seqs, pages_per_seq=pps)
    if jax_side:
        return jax_kv.KVCacheConfig(**kw, dtype=jnp.float32,
                                    kv_dtype=kv_dtype)
    return KVCacheConfig(**kw, dtype=torch.float32, kv_dtype=kv_dtype)


def _kind(config):
    return "llama" if config.position_embedding == "rope" else "flagship"


def _prompts(vocab):
    rng = np.random.RandomState(5)
    prompts = rng.randint(1, vocab, (6, 10)).astype(np.int32)
    plens = np.array([10, 8, 6, 4, 9, 5], np.int32)
    return prompts, plens


def jax_tokens(mesh, jm, params, weight_dtype=None, kv_dtype=None):
    prompts, plens = _prompts(jm.config.vocab_size)
    ccfg = _ccfg(True, MODELS[_kind(jm.config)], kv_dtype)
    fns = jm.decode_fns(params, mesh, ccfg, max_prompt_len=10,
                        weight_dtype=weight_dtype, weight_block=BLOCK)
    b = jax_serve.ContinuousBatcher(
        fns.prefill, fns.decode, jax_kv.PagedKVCache(ccfg),
        jax_kv.init_pools(ccfg), max_prompt_len=10, harvest_every=4)
    comps = b.run([jax_serve.Request(uid=i, prompt=[
        int(t) for t in prompts[i, :plens[i]]], max_new_tokens=NEW)
        for i in range(6)])
    return [comps[i].tokens for i in range(6)], fns


def port_tokens(tm, weight_dtype=None, kv_dtype=None, **kw):
    prompts, plens = _prompts(tm.config.vocab_size)
    ccfg = _ccfg(False, MODELS[_kind(tm.config)], kv_dtype)
    fns = tm.decode_fns(ccfg, max_prompt_len=10, weight_dtype=weight_dtype,
                        weight_block=BLOCK, **kw)
    b = ContinuousBatcher(fns.prefill, fns.decode, PagedKVCache(ccfg),
                          init_pools(ccfg, "cpu"), max_prompt_len=10,
                          harvest_every=4)
    comps = b.run([Request(uid=i, prompt=[int(t) for t in
                                          prompts[i, :plens[i]]],
                           max_new_tokens=NEW) for i in range(6)])
    return [comps[i].tokens for i in range(6)], fns


@pytest.mark.parametrize("weight_dtype", [None, "bf16", "int8", "int4"])
def test_width_and_weight_stream_bytes_match_jax(mesh, weight_dtype):
    jm, tm, params = models("flagship")
    _, jf = jax_tokens(mesh, jm, params, weight_dtype)
    ccfg = _ccfg(False)
    tf = tm.decode_fns(ccfg, max_prompt_len=10, weight_dtype=weight_dtype,
                       weight_block=BLOCK)
    assert tf.weight_dtype == jf.weight_dtype
    assert tf.weight_stream_bytes == jf.weight_stream_bytes
    assert tf.decode.weight_stream_bytes == tf.weight_stream_bytes
    assert tf.decode.weight_dtype == tf.weight_dtype
    if weight_dtype in ("int8", "int4"):
        assert tf.weight_stream_bytes < tm.weight_stream_bytes()


@pytest.mark.parametrize("kind, weight_dtype", [
    ("flagship", "int8"), ("flagship", "int4"), ("llama", "int4")])
def test_greedy_tokens_match_jax(mesh, kind, weight_dtype):
    jm, tm, params = models(kind)
    want, _ = jax_tokens(mesh, jm, params, weight_dtype)
    # the streams differ between requests and within them
    assert len({tuple(t) for t in want}) >= 5
    assert len({x for t in want for x in t}) >= 4
    inside, fns = port_tokens(tm, weight_dtype)
    assert inside == want and fns.weight_dtype == weight_dtype
    # a model quantized beforehand: as declared, and with the width left
    # to its structure
    qm = quantize_gpt_weights(tm, weight_dtype, BLOCK)
    assert port_tokens(qm, weight_dtype)[0] == want
    shared, fns = port_tokens(qm)
    assert shared == want and fns.weight_dtype == weight_dtype


def test_bf16_copies_match_jax_and_leave_the_model_alone(mesh):
    """``weight_dtype="bf16"`` on fp32 weights: bf16 copies made once at
    build time (the JAX cast of :1572-1579), the tokens JAX's."""
    jm, tm, params = models("flagship")
    want, _ = jax_tokens(mesh, jm, params, "bf16")
    got, fns = port_tokens(tm, "bf16")
    assert got == want and fns.weight_dtype == "bf16"
    assert tm.layers[0].qkv.weight.dtype == torch.float32


def test_mismatched_or_unknown_width_raises():
    _, tm, _ = models("flagship")
    qm = quantize_gpt_weights(tm, "int8", BLOCK)
    ccfg = _ccfg(False)
    with pytest.raises(ValueError, match="int8"):
        qm.decode_fns(ccfg, max_prompt_len=10, weight_dtype="int4")
    with pytest.raises(ValueError, match="weight_dtype must be"):
        tm.decode_fns(ccfg, max_prompt_len=10, weight_dtype="fp8")
    with pytest.raises(ValueError, match="already"):
        quantize_gpt_weights(qm, "int8", BLOCK)
    with pytest.raises(ValueError, match="layers/qkv.weight"):
        quantize_gpt_weights(tm, "int8", 36)
    with pytest.raises(ValueError, match="declared"):
        qm._check_weight_dtype("int4")


def test_tensor_parallel_pools_still_raise():
    """A pool for a tensor-parallel degree the model was not built for
    raises: ``decode_fns(tp=)`` against the group, as JAX's against its
    mesh, and ``quantize_gpt_weights(tp=)`` against the model's shards
    (tp > 1 pools, built under a group, are held in
    ``tests/test_torch_tp_decode.py``)."""
    _, tm, _ = models("flagship")
    for wd in ("int8", "int4"):
        with pytest.raises(ValueError, match="disagrees with the tensor-"):
            tm.decode_fns(_ccfg(False), max_prompt_len=10, weight_dtype=wd,
                          tp=2)
    with pytest.raises(ValueError, match="shards of tp=1"):
        quantize_gpt_weights(tm, "int4", BLOCK, tp=2)
    qm = quantize_gpt_weights(tm, "int4", BLOCK)
    with pytest.raises(ValueError, match="disagrees with the tensor-"):
        qm.decode_fns(_ccfg(False), max_prompt_len=10, tp=2)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantized_forward_matches_jax_apply(mesh, weight_dtype):
    """``apply`` on a quantized model goes through the same projections
    as JAX's ``apply`` on a quantized tree (fp32: 1e-5)."""
    jm, tm, params = models("flagship")
    toks = np.random.RandomState(2).randint(0, 64, (2, 12)).astype(np.int32)
    qp = jax_quantize(params, weight_dtype, BLOCK)
    want = apex_tpu._compat.shard_map(
        jm.apply, mesh, (jax.tree.map(lambda _: P(), qp), P()), P())(
        qp, jnp.asarray(toks))
    qm = quantize_gpt_weights(tm, weight_dtype, BLOCK)
    with torch.no_grad():
        got = qm.apply(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_quantized_reference_matches_the_paged_path():
    """The full-recompute reference on a quantized model gives the
    batcher's tokens (the gate chip_smoke holds the kernels to)."""
    _, tm, _ = models("flagship")
    qm = quantize_gpt_weights(tm, "int4", BLOCK)
    prompts, plens = _prompts(64)
    ref = qm.generate_reference(prompts, plens, NEW)
    assert port_tokens(qm)[0] == ref.tolist()
