"""The port's GPT training step against the JAX package's, on one tiny
model (2 layers, hidden 64, 2 heads, vocab 256).

The JAX model's parameter tree gives the structure; every leaf is redrawn
from a numpy seed (std 0.2) and feeds both packages, the port's through
``convert.params_from_jax``.  The JAX side runs ``jax.value_and_grad(
model.loss)`` inside a 1-device ``shard_map`` (its CPU default attention
is the XLA reference) and ``FusedAdam.step``; the port runs
``GPTModel.loss``, ``backward`` and its ``FusedAdam`` on CPU tensors (the
kernels' plain versions), at s=40 (the short rung) and s=600 (the mid
rung).

Tolerances: fp32 on both sides; the loss agrees to 1e-5, every gradient
to 1e-4 relative and 2e-6 absolute (sums over tokens and the vocab in
another order).  The first Adam step moves each weight by ``lr * g /
(|g| + eps)``, about ``lr * sign(g)``: where the gradient is at least
1e-5 the parameters after it agree to 1e-5 absolute (1% of the step);
where it is below that, it is rounding noise on both sides (the key
bias, for one, has an exact gradient of zero: a constant added to every
score of a row does not change its softmax), Adam turns the noise into a
step of up to ``lr`` either way, and only that bound is checked.  bf16 (O5 on
both sides) rounds at other points in the two frameworks: the loss is
held to 0.02 and each gradient to 3% of its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.amp.policy import get_policy as jax_get_policy
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.examples import gpt_pretrain
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=2, max_position_embeddings=640)
LR = 1e-3


@pytest.fixture(scope="module")
def mesh():
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        devices=jax.devices()[:1])
    yield mesh
    parallel_state.destroy_model_parallel()


def models(level, seed=0, **kw):
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


def jax_step(mesh, jm, params, toks, tgts):
    """``(loss, grads, params after one FusedAdam step)`` in JAX."""
    opt = JaxFusedAdam(lr=LR, master_weights=jm.config.policy.master_weights)
    specs = jm.param_specs()

    def step(p, t, y):
        loss, grads = jax.value_and_grad(jm.loss)(p, t, y)
        new_p, _ = opt.step(opt.init(p), grads, p)
        return loss, grads, new_p

    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(specs, P(), P()),
                              out_specs=(P(), specs, specs),
                              check_vma=False))
    params = jax.tree.map(jnp.asarray, params)
    return jax.tree.map(np.asarray, f(params, jnp.asarray(toks),
                                      jnp.asarray(tgts)))


def port_step(tm, toks, tgts):
    opt = FusedAdam(tm.parameters(), lr=LR,
                    master_weights=tm.config.policy.master_weights)
    loss = tm.loss(torch.from_numpy(toks), torch.from_numpy(tgts))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    opt.step()
    return loss.item(), grads, tm.state_dict()


@pytest.mark.parametrize("s", [40, 600])
def test_loss_grads_and_step_match_jax_fp32(mesh, s):
    jm, tm, params = models("O0", seed=s)
    toks, tgts = batch(s, b=2 if s < 512 else 1)
    want_loss, want_grads, want_params = jax_step(mesh, jm, params, toks,
                                                  tgts)
    loss, grads, state = port_step(tm, toks, tgts)
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


def test_o5_bf16_band(mesh):
    jm, tm, params = models("O5", seed=7)
    assert tm.layers[0].qkv.weight.dtype == torch.bfloat16
    assert tm.layers[0].ln1.scale.dtype == torch.float32
    toks, tgts = batch(48)
    want_loss, want_grads, _ = jax_step(mesh, jm, params, toks, tgts)
    loss, grads, _ = port_step(tm, toks, tgts)
    assert abs(loss - float(want_loss)) < 0.02
    want_g = convert.params_from_jax(want_grads)
    for name, g in grads.items():
        w = want_g[name].float()
        assert g.dtype == want_g[name].dtype, name
        assert (g.float() - w).norm() <= 0.03 * w.norm() + 1e-6, name


def test_remat_on_equals_off_bit_for_bit():
    _, tm, params = models("O0", seed=3)
    off = GPTModel(GPTConfig(**SIZES, policy=get_policy("O0"), remat=False),
                   device="cpu")
    off.load_state_dict(convert.params_from_jax(params))
    assert tm.config.remat
    toks, tgts = (torch.from_numpy(x) for x in batch(40))
    results = []
    for model in (tm, off):
        loss = model.loss(toks, tgts)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        model.named_parameters()}))
    (la, ga), (lb, gb) = results
    assert torch.equal(la, lb)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


def test_optimizer_state_round_trip_o5():
    jm, tm, params = models("O5", seed=9)
    jopt = JaxFusedAdam(lr=LR, master_weights=True)
    jstate = jax.tree.map(np.asarray, jopt.init(
        jax.tree.map(jnp.asarray, params)))
    jstate["step"] = np.int32(4)
    opt = FusedAdam(tm.parameters(), lr=LR, master_weights=True)
    convert.optimizer_state_from_jax(jstate, tm, opt)
    state = opt.state[tm.layers[1].fc1.weight]
    assert state["step"] == 4 and state["master"].dtype == torch.float32
    back = convert.optimizer_state_to_jax(tm, opt)
    flat_a = jax.tree_util.tree_leaves_with_path(jstate)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
        assert flat_b[path].dtype == leaf.dtype


def test_bf16_weights_round_trip_bit_exact():
    _, tm, params = models("O5", seed=11)
    back = convert.params_to_jax(tm.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        assert got.dtype == leaf.dtype
        np.testing.assert_array_equal(got.view(np.uint8), leaf.view(np.uint8))


def test_trainer_loss_falls_on_cpu():
    out = gpt_pretrain.main([
        "--vocab", "256", "--layers", "2", "--hidden", "64", "--heads", "2",
        "--seq", "64", "--micro-batch", "2", "--num-micro", "2",
        "--steps", "3", "--lr", "3e-3", "--pool", "1", "--log-every", "1",
        "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert losses[2] < losses[1] < losses[0]
    assert out["mfu"] is None          # no device peak on the CPU


@pytest.mark.parametrize("flag", [
    ["--tp", "2"], ["--pp", "2"], ["--zero"], ["--zero3"],
    ["--grad-compression", "int8"], ["--overlap-grad-sync"],
    ["--trace-dir", "t"], ["--num-experts", "4"], ["--data", "x.bin"],
    ["--checkpoint-dir", "ck"], ["--opt-level", "O2"]])
def test_trainer_rejects_unported_flags(flag, tmp_path):
    """The multi-chip flags raise naming their ROADMAP.md item; the fp16
    level O2 and the data, checkpoint and trace flags, ported since, take
    a CPU step (O2: fp16 parameters, fp32 norms and masters, the dynamic
    loss scaler; ``--data`` a token file; ``--checkpoint-dir`` the last
    step's checkpoint; ``--trace-dir`` the armed trigger).  ``--tp``,
    ported since, needs one process a rank: without a process group it
    raises naming ``torchrun`` (its spawned runs are in
    ``tests/test_torch_gpt_tp.py``)."""
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.data import write_token_file

    argv = ["--device", "cpu", "--layers", "1", "--hidden", "32", "--heads",
            "1", "--vocab", "64", "--seq", "16", "--steps", "1"] + flag
    ported = {"--opt-level", "--data", "--checkpoint-dir", "--trace-dir"}
    if flag[0] == "--tp":
        with pytest.raises(RuntimeError, match="torchrun"):
            gpt_pretrain.main(argv)
        return
    if flag[0] not in ported:
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
            gpt_pretrain.main(argv)
        return
    argv[-1] = str(tmp_path / flag[1]) if flag[0] != "--opt-level" \
        else flag[1]
    if flag[0] == "--data":
        write_token_file(argv[-1], np.arange(200) % 64)
    out = gpt_pretrain.main(argv)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    if flag[0] == "--checkpoint-dir":
        assert checkpoint.verify(str(tmp_path / "ck" / "step_0")) == []
    if flag[0] == "--trace-dir":
        assert (tmp_path / "t" / "TRACE_REQUEST").parent.is_dir()


def test_trainer_and_model_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_pretrain.main(["--layers", "1", "--hidden", "32", "--heads",
                           "1", "--vocab", "64", "--seq", "16"])
