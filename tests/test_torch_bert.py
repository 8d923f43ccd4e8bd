"""The port's BERT against the JAX package's, on one tiny model (2 layers,
hidden 64, 4 heads, vocab 256, 640 positions).

The JAX model's parameter tree gives the structure; every leaf is redrawn
from a numpy seed (std 0.2) and feeds both packages, the port's through
``convert.params_from_jax``.  The batch has ragged padding (one full row,
one cut to 60%), token types, 15% MLM positions and binary labels.  The
JAX side runs inside a 1-device ``shard_map`` without the vma check (the
BERT loss ``psum``s over the data axis) with ``attention_impl`` set to
the rung under test, so its Pallas bodies run in interpret mode; the port
runs on CPU tensors (the kernels' plain versions) with the same rung:
s=40 the short rung, s=600 the mid rung, and the flash rung forced.

Tolerances, as ``tests/test_torch_gpt_train.py``: fp32 on both sides;
hidden states and logits to 1e-5 (1e-4 relative for the logits, sums of
256 products), the loss to 1e-5, every gradient to 1e-4 relative and
2e-6 absolute; after one Adam step the parameters agree to 1% of the
step where the gradient is at least 1e-5, and elsewhere (rounding noise,
the key bias's exactly-zero gradient among it) move by at most ``lr``.
O4 (bf16 compute) rounds at other points in the two frameworks: the loss
is held to 0.02, as there.  Its gradients are held as a whole against
the fp32 gradient, not tensor by tensor against JAX's: BERT's small
tensors (the pooler, the binary head's two biases, layer 0's biases) are
sums over a few rows with much cancellation, and at this size each
framework's O4 gradient of one of them lies 3-10% of its norm from the
fp32 one (measured on the CPU; the binary bias's sign can even flip), so
a per-tensor band would test the rounding, not the port.
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
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.examples import bert_finetune
from apex_tpu_torch.models import BertConfig, BertModel
from apex_tpu_torch.optimizers import FusedAdam

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=4, max_position_embeddings=640)
LR = 1e-3
#: (sequence length, rung): the ladder's choice, then the flash rung forced
RUNGS = [(40, "short"), (600, "mid"), (72, "pallas")]


@pytest.fixture(scope="module")
def mesh():
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        devices=jax.devices()[:1])
    yield mesh
    parallel_state.destroy_model_parallel()


def models(level, rung=None, seed=0, **kw):
    jm = JaxBertModel(JaxBertConfig(**SIZES, policy=jax_get_policy(level),
                                    remat=False, attention_impl=rung, **kw))
    tm = BertModel(BertConfig(**SIZES, policy=get_policy(level),
                              attention_impl=rung, **kw), device="cpu")
    tree = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32)
        .astype(x.dtype), tree)
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, tm, params


def batch(s, b=2, seed=1):
    """tokens, MLM labels, loss mask, attention mask, binary labels,
    token types: row 0 full, row 1 padded past 60% of ``s``."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 256, (b, s)).astype(np.int32)
    lens = np.array([s, max(1, s * 3 // 5)] + [s] * (b - 2))[:b]
    mask = np.arange(s)[None] < lens[:, None]
    labels = rng.randint(0, 256, (b, s)).astype(np.int32)
    loss_mask = ((rng.rand(b, s) < 0.15) & mask).astype(np.float32)
    binary = (np.arange(b) % 2).astype(np.int32)
    types = np.broadcast_to((np.arange(s) >= s // 2), (b, s)).astype(np.int32)
    return toks, labels, loss_mask, mask, binary, types


def jax_call(mesh, jm, fn, params, *args, out=P()):
    specs = jm.param_specs()
    f = jax.jit(jax.shard_map(fn, mesh=mesh,
                              in_specs=(specs,) + (P(),) * len(args),
                              out_specs=out, check_vma=False))
    res = f(jax.tree.map(jnp.asarray, params), *map(jnp.asarray, args))
    return jax.tree.map(np.asarray, res)


def jax_step(mesh, jm, params, data):
    """``(loss, grads, params after one FusedAdam step)`` in JAX."""
    opt = JaxFusedAdam(lr=LR, master_weights=jm.config.policy.master_weights)
    specs = jm.param_specs()

    def step(p, *d):
        loss, grads = jax.value_and_grad(jm.loss)(p, *d)
        new_p, _ = opt.step(opt.init(p), grads, p)
        return loss, grads, new_p

    return jax_call(mesh, jm, step, params, *data, out=(P(), specs, specs))


def port_step(tm, data):
    opt = FusedAdam(tm.parameters(), lr=LR,
                    master_weights=tm.config.policy.master_weights)
    loss = tm.loss(*map(torch.from_numpy, data))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    opt.step()
    return loss.item(), grads, tm.state_dict()


@pytest.mark.parametrize("s, rung", RUNGS)
def test_encode_and_apply_match_jax_fp32(mesh, s, rung):
    jm, tm, params = models("O0", rung, seed=s)
    toks, _, _, mask, _, types = batch(s, seed=s)
    want_h = jax_call(mesh, jm, jm.encode, params, toks, mask, types)
    want_lm, want_bin = jax_call(mesh, jm, jm.apply, params, toks, mask,
                                 types, out=(P(), P()))
    args = map(torch.from_numpy, (toks, mask, types))
    with torch.no_grad():
        t, m, y = args
        hidden = tm.encode(t, m, y)
        lm, binary = tm.apply(t, m, y)
    np.testing.assert_allclose(hidden.numpy(), want_h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lm.numpy(), want_lm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(binary.numpy(), want_bin, rtol=1e-5,
                               atol=1e-5)
    assert binary.dtype == torch.float32 and binary.shape == (2, 2)


@pytest.mark.parametrize("s, rung", RUNGS)
def test_loss_grads_and_step_match_jax_fp32(mesh, s, rung):
    jm, tm, params = models("O0", rung, seed=s + 1)
    data = batch(s, seed=s + 1)
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


@pytest.mark.parametrize("chunk", [64, 100])
def test_fused_ce_matches_jax(mesh, chunk):
    """``BertConfig(fused_ce=True)``: the MLM loss through the fused
    chunked path, the head's per-vocab bias as its ``bias`` (chunk 64
    divides the vocab of 256; 100 shrinks to 64), loss, gradients and
    the Adam step against JAX's fused path, fp32, with the tolerances
    above."""
    jm, tm, params = models("O0", "short", seed=21, fused_ce=True,
                            fused_ce_chunk=chunk)
    data = batch(40, seed=21)
    want_loss, want_grads, want_params = jax_step(mesh, jm, params, data)
    loss, grads, state = port_step(tm, data)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    want_g = convert.params_from_jax(want_grads)
    want_p = convert.params_from_jax(want_params)
    assert grads["lm_head.bias"].abs().max() > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=name)
    for name, p in state.items():
        big = want_g[name].abs() >= 1e-5
        np.testing.assert_allclose(p[big].numpy(), want_p[name][big].numpy(),
                                   rtol=0, atol=1e-2 * LR, err_msg=name)
    # the same loss as the two-step path on the same weights
    _, two, _ = models("O0", "short", seed=21, fused_ce=False)
    with torch.no_grad():
        ref = two.loss(*map(torch.from_numpy, data)).item()
    np.testing.assert_allclose(loss, ref, rtol=1e-5, atol=1e-5)


def test_o4_bf16_band(mesh):
    """O4 (fp32 parameters and gradients, bf16 compute) through the short
    rung on both sides: the loss within 0.02 of JAX's, every gradient in
    JAX's dtype, and the whole gradient (every tensor concatenated) within
    3% of its norm of the fp32 gradient, no further from it than 1.5 times
    JAX's own O4 gradient is, plus 0.5%."""
    jm, tm, params = models("O4", "short", seed=7)
    j32, _, _ = models("O0", "short", seed=7)
    assert tm.layers[0].qkv.weight.dtype == torch.float32
    assert tm.config.compute_dtype == torch.bfloat16
    data = batch(48, b=4, seed=7)
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


@pytest.mark.parametrize("level", ["O0", "O4", "O5"])
def test_bert_tree_round_trips_exactly(level):
    """The BERT tree (tokentype_embedding, lm_head.{dense, ln, bias},
    pooler, binary_head among it) crosses both ways bit for bit."""
    _, tm, params = models(level, seed=11)
    back = convert.params_to_jax(tm.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path].view(np.uint8),
                                      leaf.view(np.uint8))
    for key in ("tokentype_embedding", "lm_head", "pooler", "binary_head"):
        assert key in back


def test_without_binary_head_the_tree_and_loss_match(mesh):
    jm, tm, params = models("O0", seed=12, add_binary_head=False)
    assert tm.pooler is None and "pooler" not in params
    data = batch(40, seed=12)
    want_loss = jax_call(mesh, jm, jm.loss, params, *data)
    with torch.no_grad():
        loss = tm.loss(*map(torch.from_numpy, data))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5, atol=1e-5)
    assert tm.apply(torch.from_numpy(data[0]))[1] is None


def test_remat_on_equals_off_bit_for_bit():
    _, tm, params = models("O0", seed=3)
    off = BertModel(BertConfig(**SIZES, policy=get_policy("O0"), remat=False),
                    device="cpu")
    off.load_state_dict(convert.params_from_jax(params))
    assert tm.config.remat
    data = list(map(torch.from_numpy, batch(40, seed=3)))
    results = []
    for model in (tm, off):
        loss = model.loss(*data)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        model.named_parameters()}))
    (la, ga), (lb, gb) = results
    assert torch.equal(la, lb)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


def test_config_and_methods_keep_the_jax_signatures():
    """Every JAX ``BertConfig`` field with its default; the model's
    methods take the JAX parameters less ``params``."""
    port = {f.name: f.default for f in dataclasses.fields(BertConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxBertConfig)}
    assert list(port) == list(ref)
    for name in ref:
        if name not in ("params_dtype", "compute_dtype"):
            assert port[name] == ref[name], name
    for name in ("encode", "mlm_hidden", "lm_logits", "binary_logits",
                 "apply", "loss", "pipeline_loss", "pipeline_grads"):
        want = [p for p in inspect.signature(getattr(JaxBertModel, name))
                .parameters if p not in ("self", "params")]
        got = list(inspect.signature(getattr(BertModel, name)).parameters)
        if name.startswith("pipeline"):
            assert got == ["self", "args", "kwargs"], name
        else:
            assert got[1:] == want, name


def test_unported_options_raise_naming_their_items():
    # fused_ce=True is ported since: test_fused_ce_matches_jax
    assert BertConfig(**SIZES, fused_ce=True).fused_ce
    with pytest.raises(NotImplementedError, match="'xla'"):
        BertConfig(**SIZES, attention_impl="xla")
    # the fp16 level O2, ported since: fp16 parameters, fp32 norms
    cfg = BertConfig(**SIZES, policy=get_policy("O2"))
    assert (cfg.params_dtype, cfg.compute_dtype, cfg.norm_dtype) == (
        torch.float16, torch.float16, torch.float32)
    tm = BertModel(BertConfig(**SIZES), device="cpu")
    for method in (tm.pipeline_loss, tm.pipeline_grads):
        with pytest.raises(NotImplementedError, match="queue A item 10"):
            method(None, None, None, 2)
    with pytest.raises(ValueError, match="position table"):
        tm.encode(torch.zeros((1, 641), dtype=torch.int32))


def test_model_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BertModel(BertConfig(**SIZES))
    with pytest.raises(RuntimeError, match="CUDA"):
        bert_finetune.main(["--steps", "1"])


def test_finetune_runs_on_cpu():
    """The example's synthetic task is the JAX example's (same seeds);
    three steps run with ``--device cpu`` and the loss stays finite."""
    from examples.bert_finetune import synthetic_task as jax_task

    ours = bert_finetune.synthetic_task(np.random.default_rng(0), 2, 4, 32,
                                        128)
    theirs = jax_task(np.random.default_rng(0), 2, 4, 32, 128)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))
    out = bert_finetune.main(["--steps", "3", "--log-every", "1",
                              "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert 0.0 <= out["eval_accuracy"] <= 1.0


@pytest.mark.parametrize("flag", [
    ["--tp", "2"], ["--zero3"], ["--dp-ici-size", "2"],
    ["--grad-compression", "int8"], ["--overlap-grad-sync"],
    ["--compress-ici-legs"], ["--metrics-jsonl", "m.jsonl"],
    ["--opt-level", "O2"]])
def test_finetune_rejects_unported_flags(flag):
    """The multi-chip flags raise naming their ROADMAP.md item; O2, ported
    since, takes a CPU step with its loss scaler."""
    argv = ["--device", "cpu", "--steps", "1"] + flag
    if flag == ["--opt-level", "O2"]:
        out = bert_finetune.main(argv)
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        bert_finetune.main(argv)
