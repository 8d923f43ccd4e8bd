"""The port's T5 against the JAX package's, on one tiny model (2 encoder
and 1 decoder layers, hidden 64, 4 heads, vocab 128, 32 positions).

The JAX model's parameter tree gives the structure; every leaf is redrawn
from a numpy seed (std 0.2) and feeds both packages, the port's through
``convert.params_from_jax``.  The encoder reads 24 tokens and the decoder
16, so cross attention runs at sq = 16 != sk = 24.  The JAX side runs
inside a 1-device ``shard_map`` without the vma check, with
``attention_impl="xla"`` (its plain attention) on the CPU; the port runs
on CPU tensors, where the kernel wrappers run their plain versions.

Tolerances, as ``tests/test_torch_bert.py``: fp32 on both sides;
hidden states to 1e-5, logits to 1e-4 relative and 1e-5 absolute, the
loss to 1e-5, every gradient to 1e-4 relative and 2e-6 absolute; after
one Adam step the parameters agree to 1% of the step where the gradient
is at least 1e-5, and elsewhere move by at most ``lr``.  O5 and O2
(bf16 and fp16 compute) round at other points in the two frameworks: the
loss is held to 0.02, every gradient in JAX's dtype, and the whole
gradient within 3% of its norm of the fp32 gradient, no further from it
than 1.5 times JAX's own plus 0.5%.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.amp.policy import get_policy as jax_get_policy
from apex_tpu.models import T5Config as JaxT5Config
from apex_tpu.models import T5Model as JaxT5Model
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.models import T5Config, T5Model
from apex_tpu_torch.optimizers import FusedAdam

SIZES = dict(vocab_size=128, num_encoder_layers=2, num_decoder_layers=1,
             hidden_size=64, num_attention_heads=4,
             max_position_embeddings=32, fused_ce_chunk=32)
S_ENC, S_DEC = 24, 16
LR, WD = 1e-3, 0.1


@pytest.fixture(scope="module")
def mesh():
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        devices=jax.devices()[:1])
    yield mesh
    parallel_state.destroy_model_parallel()


def models(level, seed=0, remat=False, **kw):
    jm = JaxT5Model(JaxT5Config(**SIZES, policy=jax_get_policy(level),
                                remat=remat, attention_impl="xla", **kw))
    tm = T5Model(T5Config(**SIZES, policy=get_policy(level), remat=remat,
                          **kw), device="cpu")
    tree = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32)
        .astype(x.dtype), tree)
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, tm, params


def batch(seed, b=2):
    rng = np.random.RandomState(seed)
    enc = rng.randint(0, 128, (b, S_ENC)).astype(np.int32)
    dec = rng.randint(0, 128, (b, S_DEC)).astype(np.int32)
    return enc, dec, np.roll(dec, -1, axis=1)


def jax_call(mesh, jm, fn, params, *args, out=P()):
    specs = jm.param_specs()
    f = jax.jit(jax.shard_map(fn, mesh=mesh,
                              in_specs=(specs,) + (P(),) * len(args),
                              out_specs=out, check_vma=False))
    res = f(jax.tree.map(jnp.asarray, params), *map(jnp.asarray, args))
    return jax.tree.map(np.asarray, res)


def jax_step(mesh, jm, params, data, weight_decay=0.0):
    """``(loss, grads, params after one FusedAdam step)`` in JAX."""
    opt = JaxFusedAdam(lr=LR, weight_decay=weight_decay,
                       master_weights=jm.config.policy.master_weights)
    specs = jm.param_specs()

    def step(p, *d):
        loss, grads = jax.value_and_grad(jm.loss)(p, *d)
        new_p, _ = opt.step(opt.init(p), grads, p)
        return loss, grads, new_p

    return jax_call(mesh, jm, step, params, *data, out=(P(), specs, specs))


def port_step(tm, data, weight_decay=0.0):
    opt = FusedAdam(tm.parameters(), lr=LR, weight_decay=weight_decay,
                    master_weights=tm.config.policy.master_weights)
    loss = tm.loss(*map(torch.from_numpy, data))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    opt.step()
    return loss.item(), grads, tm.state_dict()


def test_config_and_methods_keep_the_jax_signatures():
    """Every JAX ``T5Config`` field with its default; the model's methods
    take the JAX parameters less ``params``; the pipeline entries take
    anything and raise."""
    port = {f.name: f.default for f in dataclasses.fields(T5Config)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxT5Config)}
    assert list(port) == list(ref)
    for name in ref:
        if name not in ("params_dtype", "compute_dtype"):
            assert port[name] == ref[name], name
    for name in ("encode", "decode", "logits", "apply", "loss",
                 "_per_token_ce"):
        want = [p for p in inspect.signature(getattr(JaxT5Model, name))
                .parameters if p not in ("self", "params")]
        got = list(inspect.signature(getattr(T5Model, name)).parameters)
        assert got[1:] == want, name
    tm = T5Model(T5Config(**SIZES), device="cpu")
    for name in ("pipeline_params", "pipeline_param_specs",
                 "pipeline_split_stage", "pipeline_loss", "pipeline_grads"):
        assert hasattr(JaxT5Model, name)
        with pytest.raises(NotImplementedError, match="queue A item 9"):
            getattr(tm, name)(None, None, None, None, 2)
    with pytest.raises(NotImplementedError, match="'xla'"):
        T5Config(**SIZES, attention_impl="xla")
    with pytest.raises(ValueError, match="position table"):
        tm.encode(torch.zeros((1, 33), dtype=torch.int32))


def test_encode_decode_and_apply_match_jax_fp32(mesh):
    jm, tm, params = models("O0", seed=1)
    enc, dec, _ = batch(1)
    want_mem = jax_call(mesh, jm, jm.encode, params, enc)
    want_h = jax_call(mesh, jm, jm.decode, params, dec, want_mem)
    want_lg = jax_call(mesh, jm, jm.apply, params, enc, dec)
    with torch.no_grad():
        mem = tm.encode(torch.from_numpy(enc))
        hidden = tm.decode(torch.from_numpy(dec),
                           torch.from_numpy(want_mem.copy()))
        logits = tm.apply(torch.from_numpy(enc), torch.from_numpy(dec))
    np.testing.assert_allclose(mem.numpy(), want_mem, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hidden.numpy(), want_h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), want_lg, rtol=1e-4,
                               atol=1e-5)
    assert logits.shape == (2, S_DEC, 128)


@pytest.mark.parametrize("fused_ce", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_and_step_match_jax_fp32(mesh, fused_ce, remat):
    jm, tm, params = models("O0", seed=2 + remat, remat=remat,
                            fused_ce=fused_ce)
    data = batch(2 + remat)
    want_loss, want_grads, want_params = jax_step(mesh, jm, params, data)
    loss, grads, state = port_step(tm, data)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    want_g = convert.params_from_jax(want_grads)
    want_p = convert.params_from_jax(want_params)
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


def test_encoder_cross_weights_get_zero_grads_and_decay_as_jax(mesh):
    """The encoder layers' cross-attention parameters: zero gradients
    (not None), and an Adam step with weight decay moves them as JAX's
    step does."""
    jm, tm, params = models("O0", seed=4)
    data = batch(4)
    _, want_grads, want_params = jax_step(mesh, jm, params, data, WD)
    _, grads, state = port_step(tm, data, WD)
    want_p = convert.params_from_jax(want_params)
    cross = [n for n in grads if n.startswith("enc_layers.")
             and n.split(".")[2] in ("ln_cross", "cross_q", "cross_kv",
                                     "cross_proj")]
    assert len(cross) == 2 * 8
    before = convert.params_from_jax(params)
    for name in cross:
        assert torch.equal(grads[name], torch.zeros_like(grads[name])), name
        assert not torch.equal(state[name], before[name]), name
        np.testing.assert_allclose(state[name].numpy(),
                                   want_p[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("level", ["O5", "O2"])
def test_half_precision_bands(mesh, level):
    jm, tm, params = models(level, seed=5, fused_ce=True)
    j32, _, _ = models("O0", seed=5, fused_ce=True)
    half = torch.bfloat16 if level == "O5" else torch.float16
    assert tm.enc_layers[0].qkv.weight.dtype == half
    assert tm.enc_layers[0].ln1.scale.dtype == torch.float32
    assert tm.config.compute_dtype == half
    data = batch(5, b=4)
    want_loss, want_grads, _ = jax_step(mesh, jm, params, data)
    _, exact, _ = jax_step(mesh, j32, params, data)
    loss, grads, _ = port_step(tm, data)
    assert abs(loss - float(want_loss)) < 0.02
    want_g = convert.params_from_jax(want_grads)
    exact = convert.params_from_jax(exact)
    for name, g in grads.items():
        assert g.dtype == want_g[name].dtype, name
    flat = lambda gs: torch.cat([gs[n].float().flatten() for n in grads])
    ours, theirs, truth = flat(grads), flat(want_g), flat(exact)
    err = (ours - truth).norm() / truth.norm()
    ref_err = (theirs - truth).norm() / truth.norm()
    assert err <= 0.03 and err <= 1.5 * ref_err + 0.005, (err, ref_err)


def test_remat_on_equals_off_bit_for_bit():
    _, on, params = models("O0", seed=6, remat=True)
    _, off, _ = models("O0", seed=6, remat=False)
    data = list(map(torch.from_numpy, batch(6)))
    results = []
    for model in (on, off):
        loss = model.loss(*data)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        model.named_parameters()}))
    (la, ga), (lb, gb) = results
    assert torch.equal(la, lb)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


@pytest.mark.parametrize("level", ["O0", "O5", "O2"])
def test_t5_tree_round_trips_exactly(level):
    """Both stacks cross both ways bit for bit."""
    _, tm, params = models(level, seed=7)
    back = convert.params_to_jax(tm.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path].view(np.uint8),
                                      leaf.view(np.uint8))
    assert back["enc_layers"]["qkv"]["weight"].shape[0] == 2
    assert back["dec_layers"]["qkv"]["weight"].shape[0] == 1


def test_model_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T5Model(T5Config(**SIZES))
