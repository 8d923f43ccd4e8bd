"""The port's fused optimizers and amp policies against the JAX package.

Three steps of each JAX optimizer's ``step`` and of its port twin from the
same numpy parameters and the same numpy gradients of each step: FusedAdam
in AdamW and L2 modes, fp32 masters on (bf16 parameters) and off, the
global-norm clip, a bf16 second moment; FusedLAMB (with and without
decay, NVLAMB, the L2 moment mode, no grad averaging), FusedMixedPrecision
Lamb, FusedSGD (momentum, Nesterov, dampening, decay before and after the
momentum), FusedNovoGrad, FusedAdagrad and LARC around FusedSGD; and the
skip-step (``grads_finite``) over a finite, an overflowed and a finite
step.  Parameters and every state tree are compared after each step.

Tolerance: the update is elementwise fp32 with the same coefficients
(rounded to fp32 as JAX computes them); XLA may fuse ``a*b + c*d`` into
other roundings than PyTorch's separate kernels, and the norms (the clip,
LAMB's trust ratios, NovoGrad's second moment, LARC's rates) add in
another order, so fp32 values agree to 1e-6 relative and 1e-7 absolute (a
few fp32 ulps); bf16 values (the parameters cast from the masters, a bf16
second moment) to one bf16 ulp (rtol 8e-3).  A skipped step is held bit
for bit against the state before it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp import policy as jax_policy
from apex_tpu import optimizers as jopt_mod
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import convert
from apex_tpu_torch import optimizers as topt_mod
from apex_tpu_torch.amp import policy as port_policy
from apex_tpu_torch.optimizers import FusedAdam

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SHAPES = {"w": (6, 5), "b": (5,), "scale": (7,)}
FP32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=8e-3, atol=1e-6)


def _tree(rng, dtype, scale=1.0):
    return {k: (scale * rng.randn(*s)).astype(np.float32).astype(dtype)
            for k, s in SHAPES.items()}


CASES = {
    "adamw": dict(kw=dict(adam_w_mode=True, weight_decay=0.01), bf16=False),
    "l2": dict(kw=dict(adam_w_mode=False, weight_decay=0.01), bf16=False),
    "master_clip": dict(kw=dict(master_weights=True, max_grad_norm=1.0,
                                weight_decay=0.02), bf16=True),
    "no_bias_correction": dict(kw=dict(bias_correction=False, lr=3e-3),
                               bf16=False),
    "bf16_second_moment": dict(kw=dict(exp_avg_sq_dtype="bfloat16"),
                               bf16=False),
}


def _close(got: torch.Tensor, want: np.ndarray, what: str, scaled=False):
    """``scaled``: the absolute tolerance is 1e-6 of the tensor's largest
    magnitude (LARC, below)."""
    tol = dict(FP32_TOL if got.dtype == torch.float32 else BF16_TOL)
    want = np.asarray(want).astype(np.float32)
    if scaled and want.size:
        tol["atol"] = max(tol["atol"], 1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, **tol,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case):
    spec = CASES[case]
    kw = {"lr": 1e-2, **spec["kw"]}
    sq = kw.pop("exp_avg_sq_dtype", "float32")
    dtype = jnp.bfloat16 if spec["bf16"] else np.float32
    rng = np.random.RandomState(len(case))
    params = _tree(rng, dtype)
    jopt = JaxFusedAdam(**kw, exp_avg_sq_dtype=jnp.dtype(sq))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(convert._tensor(v))
               for k, v in params.items()}
    topt = FusedAdam(list(tparams.values()), **kw,
                     exp_avg_sq_dtype=getattr(torch, sq))
    for step in range(3):
        grads = _tree(rng, dtype, scale=3.0)
        jparams, jstate = jopt.step(jstate, jax.tree.map(jnp.asarray, grads),
                                    jparams)
        for k, p in tparams.items():
            p.grad = convert._tensor(grads[k])
        topt.step()
        for k, p in tparams.items():
            state = topt.state[p]
            assert state["step"] == int(jstate["step"]) == step + 1
            assert p.dtype == convert._tensor(params[k]).dtype
            _close(p.detach(), jparams[k], f"{case} step {step} {k}")
            for key in ("exp_avg", "exp_avg_sq", "master"):
                if key in jstate:
                    assert state[key].dtype == convert._tensor(
                        np.asarray(jstate[key][k])).dtype
                    _close(state[key], jstate[key][k],
                           f"{case} step {step} {key}.{k}")
                else:
                    assert key not in state


def test_unported_options_raise():
    """``fused_tail`` is ported: a step of FusedAdam with it equals JAX's
    fused-tail step; AMSGrad still raises, as in JAX."""
    rng = np.random.RandomState(5)
    params = _tree(rng, np.float32)
    names = sorted(params)
    jopt = JaxFusedAdam(lr=1e-2, fused_tail=True)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(convert._tensor(params[k])) for k in names]
    topt = FusedAdam(tparams, lr=1e-2, fused_tail=True)
    grads = _tree(rng, np.float32, scale=3.0)
    jparams, jstate = jopt.step(jstate, jax.tree.map(jnp.asarray, grads),
                                jparams)
    for k, p in zip(names, tparams):
        p.grad = convert._tensor(grads[k])
    topt.step()
    for k, p in zip(names, tparams):
        _close(p.detach(), jparams[k], f"fused tail {k}")
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam([torch.nn.Parameter(torch.zeros(3))], amsgrad=True)


@pytest.mark.parametrize("level", sorted(port_policy.OPT_LEVELS))
def test_policy_presets_match_jax(level):
    want = jax_policy.get_policy(level)
    got = port_policy.get_policy(level)
    name = lambda dt: None if dt is None else str(dt).replace("torch.", "")
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        want_dt = getattr(want, field)
        assert name(getattr(got, field)) == (
            None if want_dt is None else jnp.dtype(want_dt).name), field
    for field in ("opt_level", "keep_norm_fp32", "master_weights",
                  "loss_scale", "dynamic_loss_scale"):
        assert getattr(got, field) == getattr(want, field), field
    # every level trains, O1-O3 in fp16
    port_policy.check_ported(got)


def test_policy_overrides_and_bad_level():
    assert port_policy.get_policy("O5", master_weights=False,
                                  loss_scale=None).master_weights is False
    with pytest.raises(ValueError, match="letter O"):
        port_policy.get_policy("05")


# ------------------------------------------------ the other optimizers
#: name -> (JAX class, port class, keyword arguments, bf16 parameters)
OTHERS = {
    "lamb": ("FusedLAMB", dict(lr=1e-2), False),
    "lamb_no_decay": ("FusedLAMB", dict(lr=1e-2, weight_decay=0.0), False),
    "nvlamb": ("FusedLAMB", dict(lr=1e-2, weight_decay=0.0,
                                 use_nvlamb=True), False),
    "lamb_l2_no_averaging": ("FusedLAMB", dict(
        lr=1e-2, adam_w_mode=False, grad_averaging=False,
        max_grad_norm=0.0), False),
    "lamb_masters": ("FusedLAMB", dict(lr=1e-2, master_weights=True,
                                       max_grad_norm=2.0), True),
    "mixed_precision_lamb": ("FusedMixedPrecisionLamb", dict(lr=1e-2), True),
    "sgd": ("FusedSGD", dict(lr=1e-2), False),
    "sgd_momentum_decay": ("FusedSGD", dict(lr=1e-2, momentum=0.9,
                                            dampening=0.1,
                                            weight_decay=0.01), False),
    "sgd_nesterov_wd_after": ("FusedSGD", dict(
        lr=1e-2, momentum=0.9, nesterov=True, weight_decay=0.01,
        wd_after_momentum=True), False),
    "sgd_masters": ("FusedSGD", dict(lr=1e-2, momentum=0.5,
                                     master_weights=True), True),
    "novograd": ("FusedNovoGrad", dict(lr=1e-2, weight_decay=0.01), False),
    "novograd_init_zero_reg_inside": ("FusedNovoGrad", dict(
        lr=1e-2, weight_decay=0.01, init_zero=True, reg_inside_moment=True,
        grad_averaging=False), False),
    "adagrad": ("FusedAdagrad", dict(lr=1e-1, weight_decay=0.01), False),
    "adagrad_w_mode": ("FusedAdagrad", dict(lr=1e-1, weight_decay=0.01,
                                            adagrad_w_mode=True), False),
}


def _run_against_jax(jopt, topt_factory, bf16, seed, finite=(None,) * 3,
                     scaled=False):
    """Three steps of ``jopt`` (JAX) and of ``topt_factory(params)`` on
    the same numpy data (parameters in JAX's flatten order), each
    parameter and state entry compared after each step; ``finite`` gives
    each step's ``grads_finite``."""
    dtype = jnp.bfloat16 if bf16 else np.float32
    rng = np.random.RandomState(seed)
    params = _tree(rng, dtype)
    names = sorted(params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(convert._tensor(params[k]))
               for k in names}
    topt = topt_factory(list(tparams.values()))
    for step, ok in enumerate(finite):
        grads = _tree(rng, dtype, scale=3.0)
        jflag = None if ok is None else jnp.bool_(ok)
        before = {k: p.detach().clone() for k, p in tparams.items()}
        jparams, jstate = jopt.step(jstate, jax.tree.map(jnp.asarray, grads),
                                    jparams, grads_finite=jflag)
        for k, p in tparams.items():
            p.grad = convert._tensor(grads[k])
        topt.step(grads_finite=None if ok is None else torch.tensor(ok))
        inner = getattr(topt, "optimizer", topt)
        for k, p in tparams.items():
            if ok is False:
                assert torch.equal(p.detach(), before[k]), k
            _close(p.detach(), jparams[k], f"step {step} {k}", scaled)
            state = inner.state[p]
            assert int(state["step"]) == int(jstate["step"])
            for key, tree in jstate.items():
                if key == "step":
                    continue
                _close(state[key], tree[k], f"step {step} {key}.{k}", scaled)
    return topt


@pytest.mark.parametrize("case", sorted(OTHERS))
def test_other_optimizers_three_steps_match_jax(case):
    cls, kw, bf16 = OTHERS[case]
    jopt = getattr(jopt_mod, cls)(**kw)
    _run_against_jax(jopt, lambda ps: getattr(topt_mod, cls)(ps, **kw), bf16,
                     seed=len(case))


@pytest.mark.parametrize("clip", [True, False])
def test_larc_three_steps_match_jax(clip):
    """LARC around FusedSGD with momentum and decay: the rescaled
    gradients (the norms through ``multi_tensor_l2norm``) step as JAX's.
    The rates come from norms summed in another order than XLA's, so a
    rate may sit an ulp off and move a gradient by an ulp of its
    magnitude, which the momentum buffer's cancellations turn into a
    larger share of a small element: values agree to 1e-6 of each
    tensor's largest magnitude."""
    kw = dict(lr=0.05, momentum=0.9, weight_decay=0.01)
    jopt = jopt_mod.LARC(jopt_mod.FusedSGD(**kw), trust_coefficient=0.02,
                         clip=clip)
    _run_against_jax(jopt, lambda ps: topt_mod.LARC(
        topt_mod.FusedSGD(ps, **kw), trust_coefficient=0.02, clip=clip),
        False, seed=11 + clip, scaled=True)


@pytest.mark.parametrize("case", ["adam", "adam_masters_clip", "lamb",
                                  "sgd_momentum"])
def test_grads_finite_skips_as_jax(case):
    """A finite, an overflowed (``grads_finite`` false) and a finite step:
    the skipped step leaves parameters, state and the step counter as they
    were, bit for bit, and the next one continues as JAX's does."""
    cls, kw, bf16 = {
        "adam": ("FusedAdam", dict(lr=1e-2, weight_decay=0.01), False),
        "adam_masters_clip": ("FusedAdam", dict(
            lr=1e-2, master_weights=True, max_grad_norm=1.0), True),
        "lamb": ("FusedLAMB", dict(lr=1e-2), False),
        "sgd_momentum": ("FusedSGD", dict(lr=1e-2, momentum=0.9), False),
    }[case]
    jopt = getattr(jopt_mod, cls)(**kw)
    topt = _run_against_jax(jopt, lambda ps: getattr(topt_mod, cls)(ps, **kw),
                            bf16, seed=21, finite=(True, False, True))
    assert int(next(iter(topt.state.values()))["step"]) == 2


def test_step_counter_is_one_device_tensor():
    """``state["step"]`` is one 0-d int32 tensor shared by every
    parameter, advanced after the step only where it was finite."""
    ps = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    opt = FusedAdam(ps, lr=1e-2)
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()
    s0, s1 = (opt.state[p]["step"] for p in ps)
    assert s0 is s1 and s0.dtype == torch.int32 and s0.shape == ()
    opt.step(grads_finite=torch.tensor(False))
    assert int(s0) == 1
    opt.step(grads_finite=torch.tensor(True))
    assert int(s0) == 2


def test_parameters_without_a_gradient_are_skipped():
    """Where JAX updates every leaf (a zero gradient still decays and
    moves the moments), the port skips a parameter without a gradient:
    its value and state stay put while the others step."""
    ps = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    opt = FusedAdam(ps, lr=1e-2, weight_decay=0.1)
    ps[0].grad = torch.ones(3)
    opt.step()
    assert torch.equal(ps[1].detach(), torch.ones(2))
    assert not opt.state[ps[1]]
    assert not torch.equal(ps[0].detach(), torch.ones(3))
    jopt = JaxFusedAdam(lr=1e-2, weight_decay=0.1)
    jp = {"a": jnp.ones(3), "b": jnp.ones(2)}
    new, _ = jopt.step(jopt.init(jp), {"a": jnp.ones(3), "b": jnp.zeros(2)},
                       jp)
    assert not np.array_equal(np.asarray(new["b"]), np.ones(2))
