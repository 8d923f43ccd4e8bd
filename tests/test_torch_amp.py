"""The port's amp (the loss scaler, MixedPrecision, initialize, the
policies' casts), GradScaler and StepGuard against the JAX package.

The scaler's schedule is held exactly: the same seeded sequence of finite
and overflowed steps through JAX's ``LossScaler.adjust`` and the port's
gives the same scale and counters at every step, through growth at
``growth_interval``, backoff and both clamps.  ``scale`` and ``unscale``
give JAX's bits (one fp32 multiply, rounded to the gradient's dtype), and
the finite flags agree.  ``state_dict`` gives JAX's keys and values.
StepGuard's verdicts and its raise match JAX's over the same flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.amp import scaler as jscaler
from apex_tpu.resilience import guard as jguard
from apex_tpu_torch import amp, convert
from apex_tpu_torch.amp import scaler
from apex_tpu_torch.resilience import guard
from apex_tpu_torch.transformer.amp import GradScaler, model_parallel_all_finite

CFG = dict(init_scale=2.0 ** 4, growth_factor=2.0, backoff_factor=0.5,
           growth_interval=3, max_loss_scale=2.0 ** 6, min_loss_scale=2.0)


def _flags(seed: int, n: int = 60):
    rng = np.random.RandomState(seed)
    # runs of finite steps long enough to grow past the top clamp, and
    # runs of overflows long enough to reach the floor
    out = []
    while len(out) < n:
        out += [True] * rng.randint(1, 12) + [False] * rng.randint(1, 6)
    return out[:n]


def _same_state(got: scaler.ScalerState, want: jscaler.ScalerState, what):
    assert float(got.loss_scale) == float(want.loss_scale), what
    assert int(got.growth_tracker) == int(want.growth_tracker), what
    assert int(got.unskipped) == int(want.unskipped), what
    assert got.loss_scale.dtype == torch.float32
    assert got.growth_tracker.dtype == got.unskipped.dtype == torch.int32


@pytest.mark.parametrize("loss_scale", ["dynamic", 128.0, None])
@pytest.mark.parametrize("seed", [0, 1])
def test_scaler_schedule_equals_jax(loss_scale, seed):
    js = jscaler.LossScaler(loss_scale, **CFG)
    ts = scaler.LossScaler(loss_scale, **CFG)
    jst, tst = js.init(), ts.init("cpu")
    _same_state(tst, jst, "init")
    seen = set()
    for i, ok in enumerate(_flags(seed)):
        jst = js.adjust(jst, jnp.bool_(ok))
        tst = ts.adjust(tst, torch.tensor(ok))
        _same_state(tst, jst, f"step {i}")
        seen.add(float(tst.loss_scale))
    if loss_scale == "dynamic":
        # growth to the top clamp and backoff to the floor both happened
        assert {CFG["max_loss_scale"], CFG["min_loss_scale"]} <= seen
    assert ts.state_dict(tst) == js.state_dict(jst)


def _grads(rng, inf_at=None):
    g = [(rng.randn(5, 3) * 1e3).astype(np.float32),
         (rng.randn(7) * 1e3).astype(np.float32).astype(jnp.bfloat16),
         np.zeros((0,), np.float32),
         (rng.randn(4) * 1e3).astype(np.float16)]
    if inf_at is not None:
        g[inf_at].reshape(-1)[-1] = np.inf
    return g


@pytest.mark.parametrize("inf_at", [None, 0, 1, 3])
def test_scale_and_unscale_equal_jax(inf_at):
    rng = np.random.RandomState(7)
    grads = _grads(rng, inf_at)
    js, ts = jscaler.LossScaler("dynamic"), scaler.LossScaler("dynamic")
    jst, tst = js.init(), ts.init("cpu")
    loss = np.float32(2.5)
    assert float(ts.scale(tst, torch.tensor(loss))) == float(
        js.scale(jst, jnp.asarray(loss)))
    assert float(ts.inv_scale(tst)) == float(js.inv_scale(jst))
    jg, jfin = js.unscale(jst, [jnp.asarray(g) for g in grads])
    tg, tfin = ts.unscale(tst, [convert._tensor(g) for g in grads])
    assert bool(tfin) == bool(jfin) == (inf_at is None)
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(convert._array(a), np.asarray(b))
    assert bool(scaler.all_finite([convert._tensor(g) for g in grads])) == \
        bool(jscaler.all_finite([jnp.asarray(g) for g in grads]))
    out = scaler.scale_gradients([convert._tensor(g) for g in grads], 0.125)
    want = jscaler.scale_gradients([jnp.asarray(g) for g in grads], 0.125)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(convert._array(a), np.asarray(b))


def test_initialize_and_mixed_precision_equal_jax():
    over = dict(loss_scale="dynamic", init_scale=2.0 ** 10,
                growth_interval=7, min_loss_scale=4.0, master_weights=False)
    mp = amp.initialize("O5", num_losses=2, **dict(over))
    jmp = jamp.initialize("O5", num_losses=2, **dict(over))
    for field in ("opt_level", "keep_norm_fp32", "master_weights",
                  "loss_scale"):
        assert getattr(mp.policy, field) == getattr(jmp.policy, field)
    for attr in ("dynamic", "growth_factor", "backoff_factor",
                 "growth_interval", "max_loss_scale", "min_loss_scale",
                 "_static_scale"):
        assert getattr(mp.scaler, attr) == getattr(jmp.scaler, attr), attr
    rng = np.random.RandomState(3)
    tree = {"ln1": {"scale": rng.randn(4).astype(np.float32)},
            "qkv": {"weight": rng.randn(4, 6).astype(np.float32)}}
    cast, state = mp.init({k: {kk: torch.from_numpy(v) for kk, v in d.items()}
                           for k, d in tree.items()})
    jcast, jstate = jmp.init(jax.tree.map(jnp.asarray, tree))
    for k, d in tree.items():
        for kk in d:
            np.testing.assert_array_equal(convert._array(cast[k][kk]),
                                          np.asarray(jcast[k][kk]))
    assert cast["ln1"]["scale"].dtype == torch.float32
    assert cast["qkv"]["weight"].dtype == torch.bfloat16
    for loss_id, inf_at in ((1, 0), (0, None)):
        grads = _grads(rng, inf_at)
        tg, tfin, state = mp.unscale_and_adjust(
            state, [convert._tensor(g) for g in grads], loss_id=loss_id,
            finite_reduce=model_parallel_all_finite)
        jg, jfin, jstate = jmp.unscale_and_adjust(
            jstate, [jnp.asarray(g) for g in grads], loss_id=loss_id)
        assert bool(tfin) == bool(jfin) == (inf_at is None)
    assert mp.state_dict(state) == jmp.state_dict(jstate)
    assert sorted(mp.state_dict(state)) == ["loss_scaler0", "loss_scaler1"]
    again = mp.load_state_dict(mp.state_dict(state), "cpu")
    for a, b in zip(again.scaler_states, state.scaler_states):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    old = {"a": torch.zeros(3), "b": [torch.ones(2)]}
    new = {"a": torch.ones(3), "b": [torch.full((2,), 2.0)]}
    kept = mp.apply_if_finite(torch.tensor(False), old, new)
    took = mp.apply_if_finite(torch.tensor(True), old, new)
    assert torch.equal(kept["a"], old["a"]) and torch.equal(
        took["b"][0], new["b"][0])
    master = mp.make_master(cast)
    assert master["qkv"]["weight"].dtype == torch.float32
    back = mp.master_to_model(master)
    assert back["qkv"]["weight"].dtype == mp.policy.param_dtype


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4", "O5"])
def test_policy_helpers_equal_jax(level):
    pol, jpol = amp.get_policy(level), jamp.get_policy(level)
    assert pol.uses_loss_scaling == jpol.uses_loss_scaling
    assert pol.low_precision == jpol.low_precision
    assert pol.replace(master_weights=True).master_weights is True
    assert pol.describe().splitlines()[0].endswith(level)
    for path in (("layers", "ln1", "scale"), ("final_ln", "bias"),
                 ("layers", "qkv", "weight"), ("embedding", "weight"),
                 ("norm",), ("fc1", "bias")):
        jpath = tuple(jax.tree_util.DictKey(p) for p in path)
        assert amp.is_norm_param(path) == jamp.is_norm_param(jpath), path
    tree = {"mlp": {"w": np.ones(3, np.float32)}, "ln": {"s": np.ones(2)}}
    got = amp.tree_cast({k: {kk: torch.as_tensor(v) for kk, v in d.items()}
                         for k, d in tree.items()}, torch.bfloat16,
                        keep_fp32_predicate=amp.is_norm_param)
    assert got["mlp"]["w"].dtype == torch.bfloat16
    assert got["ln"]["s"].dtype == torch.float32


def test_o0_o4_o5_take_a_loss_scale_and_fp16_raises():
    """Every level trains with any loss scale, the fp16 levels O1-O3
    too."""
    for level in ("O0", "O1", "O2", "O3", "O4", "O5"):
        amp.check_ported(amp.get_policy(level, loss_scale="dynamic"))
        amp.check_ported(amp.get_policy(level, loss_scale=8.0))
        amp.check_ported(amp.get_policy(level))


def test_grad_scaler_at_world_size_one():
    """GradScaler's consensus at world size 1 is the local flag (JAX's
    pmin over one device); over a process group it raises naming A9."""
    rng = np.random.RandomState(9)
    for inf_at in (None, 1):
        grads = _grads(rng, inf_at)
        gs = GradScaler()
        st = gs.init("cpu")
        tg, fin = gs.unscale(st, [convert._tensor(g) for g in grads])
        jg, jfin = jscaler.LossScaler().unscale(
            jscaler.LossScaler().init(), [jnp.asarray(g) for g in grads])
        assert bool(fin) == bool(jfin)
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(convert._array(a), np.asarray(b))
    with pytest.raises(NotImplementedError, match="item 9"):
        model_parallel_all_finite(torch.tensor(True), group=object())


@pytest.mark.parametrize("at_floor", [False, True])
def test_step_guard_thresholds_equal_jax(at_floor):
    """The same flags through JAX's StepGuard and the port's: the same
    verdicts and counts, and DivergenceError at the same step; with the
    scale at its floor the alarm warns on the first bad step."""
    kw = dict(warn_after=2, rollback_after=3, raise_after=4)
    js = jscaler.LossScaler("dynamic", min_loss_scale=2.0)
    ts = scaler.LossScaler("dynamic", min_loss_scale=2.0)
    jg = jguard.StepGuard(scaler=js, **kw)
    tg = guard.StepGuard(scaler=ts, **kw)
    scale = 2.0 if at_floor else 1024.0
    jst = js.init()._replace(loss_scale=jnp.float32(scale))
    tst = ts.init("cpu")._replace(loss_scale=torch.tensor(scale))
    grads = {"w": torch.tensor([1.0, float("nan")])}
    seq = [True, False, True, False, False, False, False]
    for i, ok in enumerate(seq):
        try:
            want = jg.observe(jnp.bool_(ok), step=i, scaler_state=jst)
        except jguard.DivergenceError:
            with pytest.raises(guard.DivergenceError, match="consecutive"):
                tg.observe(torch.tensor(ok), step=i, scaler_state=tst,
                           grads=grads)
            assert i == len(seq) - 1
            break
        got = tg.observe(torch.tensor(ok), step=i, scaler_state=tst,
                         grads=grads)
        assert (got.action, got.consecutive_bad, got.at_scale_floor) == (
            want.action, want.consecutive_bad, want.at_scale_floor), i
    else:
        pytest.fail("the JAX guard never raised")
    assert tg.total_bad == jg.total_bad
    assert guard.locate_nonfinite(grads) == ["w (nan x1/2)"]
    with pytest.raises(NotImplementedError, match="item 10"):
        guard.StepGuard(autoresume=object())
    assert amp.StepGuard is guard.StepGuard
    assert amp.DivergenceError is guard.DivergenceError


def test_scaler_state_crosses_to_and_from_jax():
    js = jscaler.LossScaler("dynamic")
    jst = js.init()
    for ok in (True, False, True):
        jst = js.adjust(jst, jnp.bool_(ok))
    tst = convert.scaler_state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    assert scaler.LossScaler().state_dict(tst) == js.state_dict(jst)
    back = jscaler.ScalerState(**convert.scaler_state_to_jax(tst))
    assert js.state_dict(back) == js.state_dict(jst)
