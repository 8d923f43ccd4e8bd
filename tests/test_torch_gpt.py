"""The port's GPT against the JAX package's, on one small model.

Weights: the JAX model's parameter tree gives the structure; every leaf
is then redrawn from a numpy seed (std 0.2, wider than the init's 0.02
so that the logits are far from flat) and the same numpy tree feeds
both packages, the port's through ``convert.params_from_jax``.  The JAX
model runs in its CPU default (the XLA attention reference); the port
on CPU tensors (the plain versions of its kernels).

Tolerances: fp32 compute on both sides agrees to 1e-5 absolute and
relative on hidden states, K/V and logits (the same operations in
another order).  bf16 compute rounds at other points in the two
frameworks, so it is held to a logit band of 0.05 absolute: about two
bf16 ulps at the logits' magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.models import GPTConfig, GPTModel

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOGIT_BAND = 0.05
SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=64)


@pytest.fixture(scope="module")
def mesh():
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        devices=jax.devices()[:1])
    yield mesh
    parallel_state.destroy_model_parallel()


def numpy_params(jax_model, seed):
    """The JAX parameter tree with every leaf redrawn from numpy."""
    tree = jax_model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32), tree)


def models(compute="fp32", seed=0):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, compute_dtype=jdt, remat=False))
    tm = GPTModel(GPTConfig(**SIZES, compute_dtype=tdt), device="cpu")
    params = numpy_params(jm, seed)
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, tm, params


def jax_apply(mesh, jm, params, tokens, fn="apply"):
    f = jax.jit(jax.shard_map(
        lambda p, t: getattr(jm, fn)(p, t), mesh=mesh,
        in_specs=(jm.param_specs(), P()), out_specs=P(), check_vma=False))
    return jax.tree.map(np.asarray, f(params, jnp.asarray(tokens)))


def tokens(b=2, s=12, seed=1):
    return np.random.RandomState(seed).randint(0, 64, (b, s)).astype(
        np.int32)


def test_weight_round_trip_is_bit_exact():
    jm, tm, params = models()
    back = convert.params_to_jax(
        convert.params_from_jax(jax.tree.map(np.asarray, params)))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
        assert flat_b[path].dtype == leaf.dtype
    # and through the module: the state dict the model holds goes back
    # to the same tree
    again = convert.params_to_jax(tm.state_dict())
    for path, leaf in flat_a:
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(again))[path], leaf)


def test_state_dict_names_every_jax_leaf():
    jm, tm, params = models()
    state = convert.params_from_jax(params)
    assert set(state) == set(tm.state_dict())
    assert state["layers.1.qkv.weight"].shape == (32, 96)      # (in, out)
    assert "pos_embedding" in state and "final_ln.bias" in state


def test_apply_logits_match_jax_fp32(mesh):
    jm, tm, params = models()
    toks = tokens()
    want = jax_apply(mesh, jm, params, toks)
    got = tm.apply(torch.from_numpy(toks))
    assert got.shape == (2, 12, 64)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_apply_logits_bf16_band(mesh):
    jm, tm, params = models("bf16", seed=2)
    toks = tokens(seed=3)
    want = jax_apply(mesh, jm, params, toks).astype(np.float32)
    got = tm.apply(torch.from_numpy(toks)).detach().float().numpy()
    assert np.abs(got - want).max() < BF16_LOGIT_BAND


def test_prefill_forward_hidden_and_kv_match_jax(mesh):
    jm, tm, params = models(seed=4)
    toks = tokens(b=1, s=10, seed=5)
    want_h, want_k, want_v = jax_apply(mesh, jm, params, toks,
                                       fn="prefill_forward")
    with torch.no_grad():
        h, k, v = tm.prefill_forward(torch.from_numpy(toks))
    assert k.shape == (2, 1, 4, 10, 8) == want_k.shape
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)
    np.testing.assert_allclose(k.numpy(), want_k, **TOL)
    np.testing.assert_allclose(v.numpy(), want_v, **TOL)


def test_swiglu_rmsnorm_forward_matches_jax(mesh):
    kw = dict(SIZES, activation="swiglu", normalization="rmsnorm")
    jm = JaxGPTModel(JaxGPTConfig(**kw, compute_dtype=jnp.float32,
                                  remat=False))
    tm = GPTModel(GPTConfig(**kw, compute_dtype=torch.float32),
                  device="cpu")
    params = numpy_params(jm, seed=6)
    tm.load_state_dict(convert.params_from_jax(params))
    toks = tokens(seed=7)
    want = jax_apply(mesh, jm, params, toks)
    np.testing.assert_allclose(
        tm.apply(torch.from_numpy(toks)).detach().numpy(), want, **TOL)


def test_no_device_means_the_gpu(monkeypatch):
    """Without ``device=`` the model goes to the GPU, and raises where
    there is none instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTModel(GPTConfig(**SIZES))


@pytest.mark.parametrize("option", [
    dict(policy=get_policy("O1")), dict(hidden_dropout=0.1),
    dict(attention_dropout=0.1), dict(num_experts=4)])
def test_unported_config_options_raise(option):
    """Options not ported raise naming their ROADMAP.md item; dropout and
    the fp16 level O1 (fp32 parameters, fp16 compute), ported since, are
    taken (dropout applies only with a key)."""
    if "hidden_dropout" in option or "attention_dropout" in option:
        cfg = GPTConfig(**SIZES, **option)
        assert {k: getattr(cfg, k) for k in option} == option
        return
    if "policy" in option:
        cfg = GPTConfig(**SIZES, **option)
        assert (cfg.params_dtype, cfg.compute_dtype, cfg.norm_dtype) == (
            torch.float32, torch.float16, torch.float32)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        GPTConfig(**SIZES, **option)
