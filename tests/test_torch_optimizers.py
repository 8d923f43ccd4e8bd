"""The port's FusedAdam and amp policies against the JAX package.

Three steps of ``apex_tpu.optimizers.FusedAdam.step`` and of
``apex_tpu_torch.optimizers.FusedAdam`` from the same numpy parameters
and the same numpy gradients of each step: AdamW and L2 modes, fp32
masters on (bf16 parameters) and off, the global-norm clip, a bf16
second moment.  Parameters and every state tree are compared after each
step.

Tolerance: the update is elementwise fp32 with the same coefficients
(rounded to fp32 as JAX computes them); XLA may fuse ``a*b + c*d`` into
other roundings than PyTorch's separate kernels, so fp32 values agree to
1e-6 relative and 1e-7 absolute (a few fp32 ulps); bf16 values (the
parameters cast from the masters, a bf16 second moment) to one bf16 ulp
(rtol 8e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp import policy as jax_policy
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import convert
from apex_tpu_torch.amp import policy as port_policy
from apex_tpu_torch.optimizers import FusedAdam

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


def _close(got: torch.Tensor, want: np.ndarray, what: str):
    tol = FP32_TOL if got.dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol,
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
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        FusedAdam(p, fused_tail=True)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(p, amsgrad=True)


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
    if level in ("O1", "O2", "O3"):
        with pytest.raises(NotImplementedError, match="queue A item 5"):
            port_policy.check_ported(got)
    else:
        port_policy.check_ported(got)


def test_policy_overrides_and_bad_level():
    assert port_policy.get_policy("O5", master_weights=False,
                                  loss_scale=None).master_weights is False
    with pytest.raises(ValueError, match="letter O"):
        port_policy.get_policy("05")
