"""The port's Llama-mode GPT (rope, RMSNorm, SwiGLU) against the JAX
package's, on one tiny model (2 layers, hidden 64, 2 heads of 32, vocab
256).

The JAX model's parameter tree gives the structure (no ``pos_embedding``,
norms without biases, a ``fc_gate`` per layer); every leaf is redrawn
from a numpy seed (std 0.2) and feeds both packages, the port's through
``convert.params_from_jax``.  JAX runs its CPU default (the XLA attention
reference).  The port runs on CPU tensors (the kernels' plain versions),
with ``APEX_TPU_FMHA_SHORT_MAX_SEQ`` and ``APEX_TPU_FMHA_MID_MAX_SEQ`` set
low so that these short sequences take its flash rung, as long ones do
on the card; a spy shows that they did.

Tolerances, as in ``tests/test_torch_gpt_train.py``: fp32 on both sides,
the loss and hidden states to 1e-5, every gradient to 1e-4 relative and
2e-6 absolute, the parameters after one Adam step to 1% of a step where
the gradient is at least 1e-5 (elsewhere only the bound ``|step| <=
lr``).  Greedy tokens are compared exactly: at fp32 the two frameworks'
logits agree to about 1e-6, far inside the gaps between the top two
logits here.  ``generate_reference`` wraps its step in
``apex_tpu._compat.shard_map`` with the vma check on, which jax 0.9
rejects; a module-scoped fixture swaps in a ``check=False`` wrapper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu._compat
from apex_tpu.amp.policy import get_policy as jax_get_policy
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.examples import gpt_pretrain
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving import (
    ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools,
)

torch.set_num_threads(1)  # the suite's parallel workers share the cores

LLAMA = dict(position_embedding="rope", activation="swiglu",
             normalization="rmsnorm")
SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=2, max_position_embeddings=64, **LLAMA)
LR = 1e-3
NEW = 12
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


@pytest.fixture
def flash_rung(monkeypatch):
    """Send everything longer than 8 tokens to the flash rung and count
    its forward and backward launches."""
    monkeypatch.setenv("APEX_TPU_FMHA_SHORT_MAX_SEQ", "4")
    monkeypatch.setenv("APEX_TPU_FMHA_MID_MAX_SEQ", "8")
    calls = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    run_fwd = port_attention.flash_run_fwd
    run_bwd = port_attention.flash_run_bwd

    def fwd(*a, **kw):
        calls["flash_fwd"] += 1
        return run_fwd(*a, **kw)

    def bwd(kernel, *a, **kw):      # kernel: flash_bwd_dkv or flash_bwd_dq
        calls[kernel] += 1
        return run_bwd(kernel, *a, **kw)
    monkeypatch.setattr(port_attention, "flash_run_fwd", fwd)
    monkeypatch.setattr(port_attention, "flash_run_bwd", bwd)
    return calls


def models(level="O0", seed=0, **kw):
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, policy=jax_get_policy(level),
                                  remat=False, **kw))
    tm = GPTModel(GPTConfig(**SIZES, policy=get_policy(level), **kw),
                  device="cpu")
    tree = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32)
        .astype(x.dtype), tree)
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, tm, params


def batch(s, b=2, seed=1):
    toks = np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


def test_jax_llama_tree_loads_with_no_missing_or_unexpected_keys():
    """A rope model has no position table in either package, so a JAX
    Llama-mode tree fills the port's state dict exactly."""
    jm, tm, params = models()
    assert "pos_embedding" not in params
    state = convert.params_from_jax(params)
    fresh = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                     device="cpu")
    result = fresh.load_state_dict(state, strict=False)
    assert result.missing_keys == [] and result.unexpected_keys == []
    assert fresh.pos_embedding is None
    assert "layers.1.fc_gate.weight" in state
    assert "final_ln.bias" not in state and "layers.0.ln1.bias" not in state


def test_loss_grads_and_step_match_jax_fp32(mesh, flash_rung):
    jm, tm, params = models("O0", seed=5)
    toks, tgts = batch(40)
    opt = JaxFusedAdam(lr=LR, master_weights=False)
    specs = jm.param_specs()

    def step(p, t, y):
        loss, grads = jax.value_and_grad(jm.loss)(p, t, y)
        new_p, _ = opt.step(opt.init(p), grads, p)
        return loss, grads, new_p

    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(specs, P(), P()),
                              out_specs=(P(), specs, specs),
                              check_vma=False))
    want_loss, want_grads, want_params = jax.tree.map(
        np.asarray, f(jax.tree.map(jnp.asarray, params), jnp.asarray(toks),
                      jnp.asarray(tgts)))

    port_opt = FusedAdam(tm.parameters(), lr=LR, master_weights=False)
    loss = tm.loss(torch.from_numpy(toks), torch.from_numpy(tgts))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    port_opt.step()
    # remat runs each layer's forward twice: two forwards, one backward
    assert flash_rung == {"flash_fwd": 4, "flash_bwd_dkv": 2,
                          "flash_bwd_dq": 2}

    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5, atol=1e-5)
    want_g = convert.params_from_jax(want_grads)
    want_p = convert.params_from_jax(want_params)
    state = tm.state_dict()
    assert set(grads) == set(want_g) == set(state)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=name)
    before = convert.params_from_jax(params)
    for name, p in state.items():
        big = want_g[name].abs() >= 1e-5
        np.testing.assert_allclose(p[big].numpy(), want_p[name][big].numpy(),
                                   rtol=0, atol=1e-2 * LR, err_msg=name)
        assert ((p - before[name])[~big].abs() <= LR * 1.001).all(), name


def test_prefill_forward_returns_rotated_k_like_jax(mesh, flash_rung):
    jm, tm, params = models("O0", seed=6)
    toks = batch(24, b=1, seed=7)[0]
    f = jax.jit(jax.shard_map(
        lambda p, t: jm.prefill_forward(p, t), mesh=mesh,
        in_specs=(jm.param_specs(), P()), out_specs=P(), check_vma=False))
    want_h, want_k, want_v = jax.tree.map(
        np.asarray, f(params, jnp.asarray(toks)))
    with torch.no_grad():
        h, k, v = tm.prefill_forward(torch.from_numpy(toks))
    assert flash_rung["flash_fwd"] == 2
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), want_h, **tol)
    np.testing.assert_allclose(k.numpy(), want_k, **tol)
    np.testing.assert_allclose(v.numpy(), want_v, **tol)


def test_greedy_tokens_match_jax_reference_under_churn(mesh, flash_rung):
    """Six ragged prompts through two slots (three admit/retire
    generations each): the paged path (prefill on the flash rung, decode
    through the fused q-RoPE) and the port's full recompute both give the
    JAX reference's tokens."""
    jm, tm, params = models("O0", seed=3)
    rng = np.random.RandomState(3)
    prompts = rng.randint(1, 256, (6, 10)).astype(np.int32)
    plens = np.array([10, 8, 6, 4, 9, 5], np.int32)
    for i in range(6):
        prompts[i, plens[i]:] = 0
    ref = np.asarray(jm.generate_reference(params, prompts, plens, NEW,
                                           mesh=mesh))
    assert len({tuple(r) for r in ref}) == 6
    np.testing.assert_array_equal(
        tm.generate_reference(prompts, plens, NEW), ref)
    pps = -(-(10 + NEW) // PAGE)
    ccfg = KVCacheConfig(num_layers=2, num_heads=2, head_dim=32,
                         num_pages=1 + 2 * pps, page_size=PAGE, max_seqs=2,
                         pages_per_seq=pps, dtype=torch.float32)
    fns = tm.decode_fns(ccfg, max_prompt_len=10)
    comps = ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg), init_pools(ccfg, "cpu"),
        max_prompt_len=10, harvest_every=3).run(
            [Request(uid=i, prompt=prompts[i, :plens[i]].tolist(),
                     max_new_tokens=NEW) for i in range(6)])
    for i in range(6):
        assert comps[i].tokens == list(map(int, ref[i])), i
    assert flash_rung["flash_fwd"] > 0


def test_prompt_past_2048_tokens_serves_through_the_flash_rung(monkeypatch):
    """At the ladder's own thresholds a 2100-token prompt prefills on the
    flash rung; paged greedy equals full recompute, and a learned-position
    model of the same size refuses the prompt."""
    _, tm, _ = models("O0", seed=8)
    seen = []
    real = port_attention._flash_attention_kernels
    monkeypatch.setattr(port_attention, "_flash_attention_kernels",
                        lambda *a: seen.append(a[0].shape[2]) or real(*a))
    prompt = np.random.RandomState(8).randint(1, 256, (1, 2100))
    new = 4
    ref = tm.generate_reference(prompt, [2100], new)
    assert seen == [2100 + new] * (2 * new)        # 2 layers, each step
    seen.clear()
    out = tm.generate(prompt, [2100], new, page_size=64)
    assert out == [list(map(int, ref[0]))]
    assert seen == [2100, 2100]                    # the prefill
    learned = GPTModel(GPTConfig(**dict(SIZES, position_embedding="learned"),
                                 compute_dtype=torch.float32), device="cpu")
    ccfg = KVCacheConfig(num_layers=2, num_heads=2, head_dim=32,
                         num_pages=1 + 34, page_size=64, max_seqs=1,
                         pages_per_seq=34, dtype=torch.float32)
    tm.decode_fns(ccfg, max_prompt_len=2100)
    with pytest.raises(ValueError, match="learned table"):
        learned.decode_fns(ccfg, max_prompt_len=2100)


def test_optimizer_state_and_weights_round_trip_bit_exact():
    jm, tm, params = models("O5", seed=9)
    back = convert.params_to_jax(tm.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        assert got.dtype == leaf.dtype
        np.testing.assert_array_equal(got.view(np.uint8), leaf.view(np.uint8))
    jopt = JaxFusedAdam(lr=LR, master_weights=True)
    jstate = jax.tree.map(np.asarray, jopt.init(
        jax.tree.map(jnp.asarray, params)))
    jstate["step"] = np.int32(3)
    opt = FusedAdam(tm.parameters(), lr=LR, master_weights=True)
    convert.optimizer_state_from_jax(jstate, tm, opt)
    assert opt.state[tm.layers[0].fc_gate.weight]["master"].shape == (64, 256)
    again = convert.optimizer_state_to_jax(tm, opt)
    flat_a = jax.tree_util.tree_leaves_with_path(jstate)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(again))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
        assert flat_b[path].dtype == leaf.dtype


def test_trainer_trains_the_llama_mode_on_the_flash_rung(flash_rung):
    out = gpt_pretrain.main([
        "--vocab", "256", "--layers", "2", "--hidden", "64", "--heads", "2",
        "--seq", "48", "--micro-batch", "2", "--num-micro", "1",
        "--position-embedding", "rope", "--activation", "swiglu",
        "--normalization", "rmsnorm", "--steps", "3", "--lr", "3e-3",
        "--pool", "1", "--log-every", "1", "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert losses[2] < losses[1] < losses[0]
    assert flash_rung["flash_bwd_dq"] == 6          # 2 layers x 3 steps


def test_config_checks():
    with pytest.raises(ValueError, match="even head_dim"):
        GPTConfig(**dict(SIZES, hidden_size=30))
    cfg = GPTConfig(**SIZES, attention_impl="pallas")
    assert cfg.rope_base == 10000.0
    with pytest.raises(NotImplementedError, match="'xla'"):
        GPTConfig(**SIZES, attention_impl="xla")
