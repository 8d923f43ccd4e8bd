"""The port's packed optimizer tail (``fused_tail=True``,
``optimizers/fused_tail.py``) against the JAX package's.

Three steps of FusedAdam and FusedLAMB with ``fused_tail=True`` from the
same numpy parameters and gradients, with ``bucket_bytes`` small enough
for several buckets: the buckets' names and sizes equal JAX's
``tail_plan``, the parameters and ``unpack_state`` equal JAX's;
``step_scaled`` with an injected inf skips everything bit for bit, as
JAX's; the fold of the unscale equals JAX's ``fold_grads`` bit for bit.
``convert`` carries a packed JAX state (and the device step counter) into
the port and back exactly.  The trainer with ``--fused-opt-tail`` gives
the per-leaf path's bits, and at O0 goes through the loss scaler.

Tolerance: as ``test_torch_optimizers.py``'s fp32 band (1e-6 relative,
1e-7 absolute, one bf16 ulp for bf16 values): JAX's own fused tail sits
an ulp off its per-leaf path on this host, and the norms add in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.amp.policy import get_policy as jax_get_policy
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers import fused_tail as jtail
from apex_tpu.parallel.overlap import GradientBuckets as JaxBuckets
from apex_tpu_torch import convert
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.examples import gpt_pretrain
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.optimizers import fused_tail

SHAPES = {"a": (6, 5), "b": (5,), "c": (7,), "d": (3, 4), "e": (9,)}
NAMES = sorted(SHAPES)
BUCKET_BYTES = 64
FP32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=8e-3, atol=1e-6)


def _tree(rng, dtype, scale=1.0):
    return {k: (scale * rng.randn(*s)).astype(np.float32).astype(dtype)
            for k, s in SHAPES.items()}


def _close(got, want, what):
    tol = FP32_TOL if got.dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol,
                               err_msg=what)


CASES = {
    "adam": (JaxFusedAdam, FusedAdam, dict(lr=1e-2, weight_decay=0.01),
             False),
    "adam_masters_clip": (JaxFusedAdam, FusedAdam, dict(
        lr=1e-2, master_weights=True, max_grad_norm=1.0), True),
    "lamb": (JaxFusedLAMB, FusedLAMB, dict(lr=1e-2), False),
    "lamb_masters": (JaxFusedLAMB, FusedLAMB, dict(
        lr=1e-2, master_weights=True), True),
}


def _pair(case, seed=0):
    jcls, tcls, kw, bf16 = CASES[case]
    dtype = jnp.bfloat16 if bf16 else np.float32
    rng = np.random.RandomState(seed)
    params = _tree(rng, dtype)
    jopt = jcls(**kw, fused_tail=True, bucket_bytes=BUCKET_BYTES)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(convert._tensor(params[k])) for k in NAMES]
    topt = tcls(tparams, **kw, fused_tail=True, bucket_bytes=BUCKET_BYTES)
    return rng, dtype, jopt, jparams, jstate, tparams, topt


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_fused_steps_match_jax(case):
    rng, dtype, jopt, jparams, jstate, tparams, topt = _pair(case)
    for step in range(3):
        grads = _tree(rng, dtype, scale=3.0)
        jparams, jstate = jopt.step(jstate, jax.tree.map(jnp.asarray, grads),
                                    jparams)
        for k, p in zip(NAMES, tparams):
            p.grad = convert._tensor(grads[k])
        topt.step()
        for k, p in zip(NAMES, tparams):
            _close(p.detach(), jparams[k], f"{case} step {step} {k}")
        # the buckets: JAX's names, sizes and values
        plan = topt._tail.plan
        jplan = jtail.tail_plan(jparams, BUCKET_BYTES)
        assert plan.names == jplan.names and len(plan.names) >= 3
        assert [b.size for b in plan.buckets] == [b.size for b in
                                                  jplan.buckets]
        assert [b.leaf_ids for b in plan.buckets] == [
            b.leaf_ids for b in jplan.buckets]
        for key, bufs in topt._tail.bufs.items():
            for name in plan.names:
                _close(bufs[name], jstate[key][name],
                       f"{case} step {step} {key}.{name}")
        # unpack_state equals JAX's, parameter by parameter
        got = topt.unpack_state()
        want = jopt.unpack_state(jstate, jparams)
        assert int(got["step"]) == int(want["step"]) == step + 1
        for key in want:
            if key == "step":
                continue
            for k, t in zip(NAMES, got[key]):
                assert t.dtype == torch.float32
                _close(t, want[key][k], f"{case} unpack {key}.{k}")
        # each parameter's state is a view of the buffers
        state = topt.state[tparams[0]]
        assert state["exp_avg"].untyped_storage().data_ptr() in {
            b.untyped_storage().data_ptr()
            for b in topt._tail.bufs["exp_avg"].values()}


@pytest.mark.parametrize("case", ["adam_masters_clip", "lamb"])
@pytest.mark.parametrize("fused", [True, False])
def test_step_scaled_skips_an_overflow_bit_for_bit(case, fused):
    """``step_scaled``: an inf among the scaled gradients leaves every
    parameter, buffer and the step counter as they were (JAX's flag
    false too); the next, finite, step equals JAX's ``step_scaled``."""
    jcls, tcls, kw, bf16 = CASES[case]
    dtype = jnp.bfloat16 if bf16 else np.float32
    rng = np.random.RandomState(3)
    params = _tree(rng, dtype)
    jopt = jcls(**kw, fused_tail=fused, bucket_bytes=BUCKET_BYTES)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(convert._tensor(params[k])) for k in NAMES]
    topt = tcls(tparams, **kw, fused_tail=fused, bucket_bytes=BUCKET_BYTES)
    inv = 2.0 ** -10
    for step, poison in enumerate((False, True, False)):
        grads = _tree(rng, dtype, scale=3.0 * 2 ** 10)
        if poison:
            grads["c"][-1] = np.inf
        before = ([p.detach().clone() for p in tparams],
                  {k: [None if t is None else t.clone() for t in v]
                   for k, v in topt.unpack_state().items() if k != "step"})
        jparams, jstate, jfin = jopt.step_scaled(
            jstate, jax.tree.map(jnp.asarray, grads), jparams,
            jnp.float32(inv))
        for k, p in zip(NAMES, tparams):
            p.grad = convert._tensor(grads[k])
        fin = topt.step_scaled(torch.tensor(inv))
        assert bool(fin) == bool(jfin) == (not poison)
        if poison:
            assert all(torch.equal(p.detach(), b)
                       for p, b in zip(tparams, before[0]))
            for key, vals in topt.unpack_state().items():
                if key == "step":
                    continue
                assert all(a is None or torch.equal(a, b)
                           for a, b in zip(vals, before[1][key]))
        assert int(topt.unpack_state()["step"]) == int(jstate["step"])
        for k, p in zip(NAMES, tparams):
            _close(p.detach(), jparams[k], f"{case} step {step} {k}")


def test_fold_grads_and_plan_helpers_equal_jax():
    rng = np.random.RandomState(5)
    grads = [(1e3 * rng.randn(*s)).astype(np.float32).astype(d)
             for s, d in zip(SHAPES.values(), (np.float32, jnp.bfloat16,
                                               np.float16, np.float32,
                                               jnp.bfloat16))]
    for inv in (None, 2.0 ** -7):
        got, fin = fused_tail.fold_grads(
            [convert._tensor(g) for g in grads],
            None if inv is None else torch.tensor(inv))
        want, jfin = jtail.fold_grads(
            [jnp.asarray(g) for g in grads],
            None if inv is None else jnp.float32(inv))
        assert bool(fin) == bool(jfin)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's copy of the bucket plan, over mixed dtypes and sizes
    shapes = [(4, 3), (0,), (), (17,), (2, 2, 2), (1000,)]
    dtypes = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16,
              torch.bfloat16, torch.float32]
    jd = [jnp.float32 if d == torch.float32 else jnp.bfloat16
          for d in dtypes]
    for nbytes in (1, 40, 64, 4096):
        got = fused_tail.GradientBuckets.from_shapes(shapes, dtypes, nbytes)
        want = JaxBuckets.from_shapes(shapes, jd, nbytes)
        assert got.names == want.names
        assert [(b.leaf_ids, b.sizes) for b in got.buckets] == [
            (b.leaf_ids, b.sizes) for b in want.buckets]
    leaves = [torch.arange(float(np.prod(s))).reshape(s) for s in shapes]
    plan = fused_tail.tail_plan(leaves, 64)
    bufs = fused_tail.pack_tree(plan, leaves)
    back = fused_tail.unpack_bufs(plan, bufs, leaves)
    assert all(torch.equal(a, b) for a, b in zip(back, leaves))
    ctx = fused_tail.TailContext(plan, tuple(l.shape for l in leaves))
    views = ctx.views(bufs)
    assert all(torch.equal(a, b) for a, b in zip(views, leaves))
    assert all(torch.equal(ctx.pack_views(views)[n], bufs[n])
               for n in plan.names)
    np.testing.assert_allclose(float(ctx.global_norm(views)), float(
        torch.linalg.vector_norm(torch.cat([l.reshape(-1) for l in leaves]))),
        rtol=1e-6)
    jparams = {k: jnp.zeros(s, jnp.bfloat16) for k, s in SHAPES.items()}
    tparams = [torch.zeros(SHAPES[k], dtype=torch.bfloat16) for k in NAMES]
    for master in (True, False):
        jopt = JaxFusedAdam(master_weights=master, fused_tail=True)
        topt = FusedAdam([torch.nn.Parameter(t) for t in tparams],
                         master_weights=master, fused_tail=True)
        assert fused_tail.tail_traffic_bytes(tparams, topt) == \
            jtail.tail_traffic_bytes(jparams, jopt)
    ps = [torch.nn.Parameter(torch.ones(8))]
    ps[0].grad = torch.ones(8)
    timing = fused_tail.time_opt_tail(FusedAdam(ps, fused_tail=True),
                                      iters=2, warmup=1)
    assert timing["bytes"] == 8 * (2 * 4 + 2 * 4 + 2 * 4 + 4)
    assert timing["ms"] > 0


SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=2, max_position_embeddings=64)


def _gpt(level="O5"):
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, policy=jax_get_policy(level),
                                  remat=False))
    tm = GPTModel(GPTConfig(**SIZES, policy=get_policy(level)), device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm.load_state_dict(convert.params_from_jax(params))
    return tm, params


@pytest.mark.parametrize("port_fused", [True, False])
def test_convert_carries_a_packed_state_both_ways(port_fused):
    """A JAX FusedAdam state packed by ``fused_tail`` (after two steps, so
    moments and masters are not zeros) loads into the port's packed or
    per-leaf layout, with one device step counter, and converts back to
    the same packed buckets bit for bit."""
    tm, params = _gpt()
    jopt = JaxFusedAdam(lr=1e-3, master_weights=True, fused_tail=True,
                        bucket_bytes=4096)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    rng = np.random.RandomState(2)
    for _ in range(2):
        grads = jax.tree.map(lambda x: jnp.asarray(
            rng.randn(*x.shape).astype(np.float32)).astype(x.dtype), jp)
        jp, jstate = jopt.step(jstate, grads, jp)
    jstate = jax.tree.map(np.asarray, jstate)
    opt = FusedAdam(tm.parameters(), lr=1e-3, master_weights=True,
                    fused_tail=port_fused, bucket_bytes=4096)
    convert.optimizer_state_from_jax(jstate, tm, opt)
    steps = {id(opt.state[p]["step"]) for p in tm.parameters()}
    assert len(steps) == 1 and int(opt.state[next(iter(
        tm.parameters()))]["step"]) == 2
    # per leaf, the port's state is JAX's unpacked state
    want = jax.tree.map(np.asarray, jopt.unpack_state(
        jax.tree.map(jnp.asarray, jstate), jp))
    for key in ("exp_avg", "exp_avg_sq", "master"):
        per = convert.params_from_jax(want[key])
        for name, p in tm.named_parameters():
            assert torch.equal(opt.state[p][key].float(), per[name].float()), \
                (key, name)
    if port_fused:
        back = convert.optimizer_state_to_jax(tm, opt)
        assert int(back["step"]) == 2
        for key in ("exp_avg", "exp_avg_sq", "master"):
            assert sorted(back[key]) == sorted(jstate[key])
            for name in jstate[key]:
                np.testing.assert_array_equal(back[key][name],
                                              jstate[key][name])


def _trainer(*extra, level="O5"):
    return gpt_pretrain.Trainer(gpt_pretrain.parse_args([
        "--vocab", "256", "--layers", "2", "--hidden", "64", "--heads", "2",
        "--seq", "32", "--micro-batch", "2", "--num-micro", "1",
        "--opt-level", level, "--lr", "3e-3", "--device", "cpu", *extra]))


def test_trainer_fused_tail_gives_the_per_leaf_bits():
    leaf, fused = _trainer(), _trainer("--fused-opt-tail")
    assert fused.opt.fused_tail and not leaf.opt.fused_tail
    batch = leaf.to_device(*gpt_pretrain.batches(
        np.random.default_rng(0), 1, 2, 32, 256)[0])
    losses = [[float(tr.step(*batch)) for _ in range(3)]
              for tr in (leaf, fused)]
    assert losses[0] == losses[1] and losses[0][2] < losses[0][0]
    for a, b in zip(leaf.model.parameters(), fused.model.parameters()):
        assert torch.equal(a, b)


def test_o0_trainer_goes_through_the_scaler():
    """O0 has a static loss scale of 1.0: the trainer scales the loss,
    unscales and checks the gradients, and skips an overflowed step (an
    inf injected into one gradient) bit for bit, as JAX's train_step."""
    tr = _trainer(level="O0")
    assert tr.use_scaler and tr.mp.scaler._static_scale == 1.0
    batch = tr.to_device(*gpt_pretrain.batches(
        np.random.default_rng(0), 1, 2, 32, 256)[0])
    tr.step(*batch)
    assert bool(tr.finite)
    before = [p.detach().clone() for p in tr.model.parameters()]
    p0 = next(iter(tr.model.parameters()))
    handle = p0.register_hook(lambda g: torch.full_like(g, float("inf")))
    tr.step(*batch)
    handle.remove()
    assert not bool(tr.finite)
    assert all(torch.equal(a, b) for a, b in
               zip(tr.model.parameters(), before))
    assert int(tr.amp_state.scaler_states[0].unskipped) == 1
    assert tr.mp.scaler.state_dict(tr.amp_state.scaler_states[0])[
        "loss_scale"] == 1.0
