"""The fp16 opt levels O1-O3: the port's GPT training step against the JAX
package's, on one tiny model (2 layers, hidden 64, 2 heads, vocab 256).
Serving at these levels is held in ``tests/test_torch_serving_fp16.py``.

The JAX model's parameter tree at each level gives the structure and the
dtypes (O1: fp32 parameters; O2: fp16 with fp32 norms; O3: all fp16);
every leaf is redrawn from a numpy seed (std 0.2) and feeds both
packages, the port's through ``convert.params_from_jax``.  Both take
their level's policy with a dynamic loss scale (``amp.initialize(level,
loss_scale="dynamic")``): the scaled loss's gradient, the scaler's
unscale and overflow check, ``FusedAdam`` (fp32 masters at O2) skipped on
an overflow.  The JAX side runs its default attention (the XLA
reference) inside a 1-device ``shard_map``, the port its kernels' plain
versions on CPU tensors.

Tolerances: fp16 rounds at other points in the two frameworks (XLA fuses
and keeps some intermediates in fp32), 2**-11 relative a rounding: the
loss is held to 5e-3 and each gradient to 1% of its norm (the bf16 band
of ``test_torch_gpt_train.py`` is 3%, for 8 bits fewer).  Over 4 steps
with an inf put into the third step's gradients on both sides, the
finite flags and the loss scales must be the same, step for step: the
overflowed step skipped, the scale halved, the next step taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import amp, convert
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=2, max_position_embeddings=128)
LR = 1e-3
STEPS, POISONED = 4, 2


@pytest.fixture(scope="module")
def mesh():
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        devices=jax.devices()[:1])
    yield mesh
    parallel_state.destroy_model_parallel()


def models(level, seed):
    policy = jamp.get_policy(level, loss_scale="dynamic")
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, policy=policy, remat=False))
    tm = GPTModel(GPTConfig(**SIZES, policy=amp.get_policy(level)),
                  device="cpu")
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32)
        .astype(x.dtype), jm.init(jax.random.PRNGKey(0)))
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, tm, params


def batches(seed, s=48, b=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.randint(0, 256, (b, s)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def jax_train(mesh, jm, params, data, level):
    """``[(loss, unscaled grads, finite, scale after)]`` a step."""
    mp = jamp.initialize(level, loss_scale="dynamic")
    opt = JaxFusedAdam(lr=LR, master_weights=mp.policy.master_weights)
    specs = jm.param_specs()

    def grads_of(p, t, y, scale):
        def scaled(p):
            loss = jm.loss(p, t, y)
            return loss.astype(jnp.float32) * scale, loss
        (_, loss), g = jax.value_and_grad(scaled, has_aux=True)(p)
        return loss, g

    f = jax.jit(jax.shard_map(grads_of, mesh=mesh,
                              in_specs=(specs, P(), P(), P()),
                              out_specs=(P(), specs), check_vma=False))
    params = jax.tree.map(jnp.asarray, params)
    state = mp.init()
    opt_state = opt.init(params)
    rows = []
    for i, (toks, tgts) in enumerate(data):
        loss, g = f(params, jnp.asarray(toks), jnp.asarray(tgts),
                    state.scaler_states[0].loss_scale)
        if i == POISONED:
            g = dict(g, embedding=dict(g["embedding"], weight=g["embedding"][
                "weight"].at[0, 0].set(jnp.inf)))
        g, finite, state = mp.unscale_and_adjust(state, g)
        params, opt_state = opt.step(opt_state, g, params,
                                     grads_finite=finite)
        rows.append((float(loss), jax.tree.map(np.asarray, g), bool(finite),
                     float(state.scaler_states[0].loss_scale)))
    return rows


def port_train(tm, data, level):
    mp = amp.initialize(level, loss_scale="dynamic")
    opt = FusedAdam(tm.parameters(), lr=LR,
                    master_weights=mp.policy.master_weights)
    state = mp.init(device="cpu")
    rows = []
    for i, (toks, tgts) in enumerate(data):
        opt.zero_grad(set_to_none=True)
        loss = tm.loss(torch.from_numpy(toks), torch.from_numpy(tgts))
        mp.scale_loss(state, loss).backward()
        if i == POISONED:
            tm.embedding.weight.grad[0, 0] = float("inf")
        grads = [p.grad for p in tm.parameters()]
        _, finite, state = mp.unscale_and_adjust(state, grads)
        opt.step(grads_finite=finite)
        rows.append((loss.item(), {n: p.grad.clone() for n, p in
                                   tm.named_parameters()}, bool(finite),
                     float(state.scaler_states[0].loss_scale)))
    return rows


@pytest.mark.parametrize("level", ["O1", "O2", "O3"])
def test_fp16_levels_match_jax_with_an_overflow(mesh, level):
    jm, tm, params = models(level, seed=31)
    want_dtypes = {"O1": (torch.float32, torch.float32),
                   "O2": (torch.float16, torch.float32),
                   "O3": (torch.float16, torch.float16)}[level]
    assert (tm.layers[0].qkv.weight.dtype,
            tm.layers[0].ln1.scale.dtype) == want_dtypes
    assert tm.config.compute_dtype == torch.float16
    data = batches(seed=32)
    want = jax_train(mesh, jm, params, data, level)
    got = port_train(tm, data, level)
    # the same steps skipped, the same loss-scale trajectory
    assert [r[2] for r in got] == [r[2] for r in want] == [
        True, True, False, True]
    assert [r[3] for r in got] == [r[3] for r in want]
    assert got[POISONED][3] == got[POISONED - 1][3] / 2
    # step 1's loss and unscaled gradients within the fp16 bands
    assert abs(got[0][0] - want[0][0]) < 5e-3
    want_g = convert.params_from_jax(want[0][1])
    for name, g in got[0][1].items():
        w = want_g[name].float()
        assert g.dtype == want_g[name].dtype, name
        assert (g.float() - w).norm() <= 0.01 * w.norm() + 1e-6, name
    for (lg, *_), (lw, *_) in zip(got, want):
        assert abs(lg - lw) < 1e-2


@pytest.mark.parametrize("level", ["O1", "O2", "O3"])
def test_fp16_parameter_trees_cross_from_jax(level):
    """``convert`` carries JAX's tree at each fp16 level as it is: fp16
    leaves, fp32 norms at O2, bit for bit; the fp32 masters of JAX's
    optimizer state cross too."""
    jm, tm, params = models(level, seed=33)
    back = convert.params_to_jax(tm.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        assert flat[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat[path].view(np.uint8),
                                      leaf.view(np.uint8))
    if level == "O2":
        jopt = JaxFusedAdam(lr=LR, master_weights=True)
        jstate = jax.tree.map(np.asarray, jopt.init(
            jax.tree.map(jnp.asarray, params)))
        opt = FusedAdam(tm.parameters(), lr=LR, master_weights=True)
        convert.optimizer_state_from_jax(jstate, tm, opt)
        st = opt.state[tm.layers[0].qkv.weight]
        assert st["master"].dtype == torch.float32
        np.testing.assert_array_equal(
            st["master"].numpy(),
            tm.layers[0].qkv.weight.detach().float().numpy())

