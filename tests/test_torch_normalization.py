"""The port's layer norm modules against the JAX package's, on the CPU.

``FusedLayerNorm``, ``MixedFusedLayerNorm`` and ``FusedRMSNorm`` of
``apex_tpu.normalization`` (flax modules, ``implementation="pallas"``:
the Pallas body of ``_ln_fwd_kernel`` in interpret mode on the CPU, as
the JAX package's own tests run it) and of ``apex_tpu_torch.
normalization`` (``nn.Module``s over the ``ln_fwd``/``ln_bwd`` kernels'
plain versions on CPU tensors), and contrib's ``FastLayerNorm``.  The
JAX variables are drawn from a numpy seed and carried to the port by
``convert.layer_from_jax``; the same numpy input and output gradient go
through both, forward and ``jax.vjp`` against autograd.

Tolerances: fp32 outputs and dx to 1e-5 relative (and 1e-5 absolute
near zero: two fp32 reductions in different orders); dscale and dbias,
sums over the rows, to 1e-5 relative and 1e-5 absolute (1e-4 for the
fp32 sums of bf16-rounded terms of a bf16 input).  bf16 results
within two bf16 ulps of each element (the ulp taken at no less than
2**-8 of the tensor's largest magnitude): both sides round fp32 values
that differ in their last fp32 bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import normalization as jnorm
from apex_tpu.contrib import layer_norm as jfast
from apex_tpu_torch import convert
from apex_tpu_torch import normalization as tnorm
from apex_tpu_torch.contrib import layer_norm as tfast
from apex_tpu_torch.ops import layer_norm as tln
from apex_tpu_torch.ops.common import launch_counts

torch.set_num_threads(1)  # the suite's parallel workers share the cores

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def assert_bf16_ulps(got, want, n=2):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mag = np.maximum(np.abs(want), np.abs(got))
    mag = np.maximum(mag, np.abs(want).max() * 2.0 ** -8)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    off = np.abs(got - want)
    assert (off <= n * ulp).all(), float((off / ulp).max())


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return a.detach().float().numpy()


def _pair(kind, shape, affine=True, param_dtype=torch.float32, seed=0,
          fast=False):
    """The JAX module with seeded variables and the port's module with
    them loaded through ``convert``."""
    kw = {} if kind == "MixedFusedLayerNorm" else dict(
        elementwise_affine=affine)
    jcls = jfast.FastLayerNorm if fast else getattr(jnorm, kind)
    tcls = tfast.FastLayerNorm if fast else getattr(tnorm, kind)
    jm = jcls(shape, param_dtype=JAX_DTYPE[param_dtype],
              implementation="pallas", **kw)
    sizes = (shape,) if isinstance(shape, int) else tuple(shape)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((2,) + sizes))
    rng = np.random.RandomState(seed)
    variables = jax.tree.map(
        lambda a: jnp.asarray(1.0 + 0.2 * rng.randn(*a.shape), a.dtype),
        variables)
    tm = tcls(shape, param_dtype=param_dtype, device="cpu", **kw)
    tm.load_state_dict(convert.layer_from_jax(
        jax.tree.map(np.asarray, variables)))
    return jm, variables, tm


def _run(jm, variables, tm, x, dy):
    """Forward and gradients of both sides: ``(y, dx, {name: dparam})``."""
    jx = jnp.asarray(x)
    jy, vjp = jax.vjp(lambda v, x: jm.apply(v, x), variables, jx)
    dv, djx = vjp(jnp.asarray(dy, jy.dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        {jnp.float32: torch.float32,
         jnp.bfloat16: torch.bfloat16}[jx.dtype.type]).requires_grad_()
    ty = tm(tx)
    ty.backward(torch.tensor(np.asarray(jnp.asarray(dy, jy.dtype)
                                        .astype(jnp.float32))).to(ty.dtype))
    jgrads = dv.get("params", {})
    grads = {n: (_np(jgrads[n]), _t(p.grad)) for n, p in
             tm.named_parameters()}
    return (_np(jy), _t(ty), jy.dtype, ty.dtype), (_np(djx), _t(tx.grad)), \
        grads


CASES = [
    ("FusedLayerNorm", 64, True),
    ("FusedLayerNorm", (4, 16), True),
    ("FusedLayerNorm", 48, False),
    ("FusedRMSNorm", 64, True),
    ("FusedRMSNorm", (2, 24), True),
    ("FusedRMSNorm", 32, False),
    ("MixedFusedLayerNorm", 64, True),
    ("MixedFusedLayerNorm", (4, 8), True),
]


@pytest.mark.parametrize("kind, shape, affine", CASES,
                         ids=[f"{k}-{s}-{a}" for k, s, a in CASES])
def test_fp32_module_matches_jax(kind, shape, affine):
    jm, variables, tm = _pair(kind, shape, affine, seed=len(str(shape)))
    sizes = (shape,) if isinstance(shape, int) else shape
    rng = np.random.RandomState(3)
    x = (2.0 * rng.randn(3, 5, *sizes) + 0.5).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)
    (jy, ty, jdt, tdt), (jdx, tdx), grads = _run(jm, variables, tm, x, dy)
    assert tdt == torch.float32 and ty.shape == x.shape
    np.testing.assert_allclose(ty, jy, **FP32_TOL)
    np.testing.assert_allclose(tdx, jdx, **FP32_TOL)
    assert set(grads) == ({"weight", "bias"} if affine and kind !=
                          "FusedRMSNorm" else {"weight"} if affine else set())
    for name, (jg, tg) in grads.items():
        assert tg.shape == tuple(sizes), name
        np.testing.assert_allclose(tg, jg, **FP32_TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["FusedLayerNorm", "FusedRMSNorm"])
def test_bf16_input_fp32_params_match_jax(kind):
    """The O5 norms: bf16 activations, fp32 parameters; the output and
    dx in bf16, the parameter gradients fp32."""
    jm, variables, tm = _pair(kind, 128, seed=5)
    rng = np.random.RandomState(8)
    x = jnp.asarray(1.5 * rng.randn(6, 128) - 0.3, jnp.bfloat16)
    dy = rng.randn(6, 128).astype(np.float32)
    (jy, ty, jdt, tdt), (jdx, tdx), grads = _run(jm, variables, tm, x, dy)
    assert tdt == torch.bfloat16 and jdt == jnp.bfloat16
    assert_bf16_ulps(ty, jy)
    assert_bf16_ulps(tdx, jdx)
    for name, (jg, tg) in grads.items():
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_mixed_layer_norm_with_bf16_params_matches_jax():
    """Megatron's case: fp32 activations, bf16 parameters, the output in
    bf16 (the parameters' dtype)."""
    jm, variables, tm = _pair("MixedFusedLayerNorm", 96,
                              param_dtype=torch.bfloat16, seed=9)
    assert tm.weight.dtype == torch.bfloat16
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 7, 96) * 3.0).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)
    (jy, ty, jdt, tdt), (jdx, tdx), grads = _run(jm, variables, tm, x, dy)
    assert tdt == torch.bfloat16 and jdt == jnp.bfloat16
    assert_bf16_ulps(ty, jy)
    np.testing.assert_allclose(tdx, jdx, rtol=1e-2, atol=1e-2)
    for name, (jg, tg) in grads.items():
        assert_bf16_ulps(tg, jg)


@pytest.mark.parametrize("fast", [False, True], ids=["function", "module"])
def test_fast_layer_norm_is_the_fused_layer_norm(fast):
    """contrib's ``FastLayerNorm`` / ``fast_layer_norm`` are the fused
    layer norm, as in JAX, and match JAX's."""
    assert tfast.FastLayerNorm is tnorm.FusedLayerNorm
    assert tfast.fast_layer_norm is tln.fused_layer_norm_affine
    rng = np.random.RandomState(4)
    x = rng.randn(5, 80).astype(np.float32)
    if fast:
        jm, variables, tm = _pair("FusedLayerNorm", 80, seed=1, fast=True)
        dy = rng.randn(5, 80).astype(np.float32)
        (jy, ty, _, _), (jdx, tdx), _ = _run(jm, variables, tm, x, dy)
        np.testing.assert_allclose(tdx, jdx, **FP32_TOL)
    else:
        w = (1 + 0.1 * rng.randn(80)).astype(np.float32)
        b = (0.1 * rng.randn(80)).astype(np.float32)
        jy = np.asarray(jfast.fast_layer_norm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 80,
            implementation="pallas"))
        ty = tfast.fast_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), 80).numpy()
    np.testing.assert_allclose(ty, jy, **FP32_TOL)


@pytest.mark.parametrize("name", jnorm.__all__)
def test_package_reexports_the_jax_names(name):
    """Every name of ``apex_tpu.normalization`` is in the port's; the
    functional ones are ``ops.layer_norm``'s entries themselves."""
    assert name in tnorm.__all__
    if name.startswith(("fused_", "mixed_")):
        assert getattr(tnorm, name) is getattr(tln, name)


@pytest.mark.parametrize("kind", ["FusedLayerNorm", "MixedFusedLayerNorm",
                                  "FusedRMSNorm"])
def test_variables_round_trip_through_convert(kind):
    """``layer_to_jax(flax=True)`` gives back JAX's variables tree, bit
    for bit (bf16 parameters too)."""
    jm, variables, tm = _pair(kind, (3, 8), param_dtype=torch.bfloat16,
                              seed=6)
    back = convert.layer_to_jax(tm.state_dict(), flax=True)
    want = jax.tree.map(np.asarray, variables)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (a.view(np.uint16) == b.view(np.uint16)).all()


def test_modules_run_the_kernels_plain_versions_on_the_cpu():
    """On CPU tensors no kernel is launched (the wrappers take the plain
    versions because the tensors lie on the CPU); the parameters are
    ones and zeros of ``param_dtype``, as flax's initializers make them."""
    before = dict(launch_counts())
    for cls in (tnorm.FusedLayerNorm, tnorm.FusedRMSNorm,
                tnorm.MixedFusedLayerNorm):
        m = cls(16, device="cpu")
        assert (m.weight == 1).all() and m.weight.dtype == torch.float32
        if m.bias is not None:
            assert (m.bias == 0).all()
        x = torch.randn(3, 16, requires_grad=True)
        m(x).sum().backward()
    assert dict(launch_counts()) == before


def test_modules_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tnorm.FusedLayerNorm, tnorm.FusedRMSNorm,
                tnorm.MixedFusedLayerNorm, tfast.FastLayerNorm):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(16)


def test_implementation_is_checked_as_in_the_ops_entries():
    m = tnorm.FusedLayerNorm(8, implementation="xla", device="cpu")
    with pytest.raises(Exception, match="xla"):
        m(torch.randn(2, 8))
