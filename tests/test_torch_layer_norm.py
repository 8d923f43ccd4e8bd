"""The port's fused LayerNorm / RMSNorm against the JAX package.

The same numpy inputs go through ``apex_tpu.ops.layer_norm`` with
``implementation="pallas"`` (the Pallas body of ``_ln_fwd_kernel`` in
interpret mode on the CPU, plus the JAX affine epilogue) and through
``apex_tpu_torch.ops.layer_norm`` on CPU tensors (the CUDA kernels' plain
versions, which compute the same function).

Tolerances: fp32 statistics and output agree to 1e-5 absolute and
relative, the rounding of two fp32 reductions taken in different
orders.  bf16 outputs agree to one bf16 ulp at the output's magnitude
(rtol 1e-2, atol 2e-2): both round the same fp32 value, but the two
fp32 values may sit on either side of a rounding boundary.

Gradients (``jax.vjp`` of the JAX affine functions, the normalization's
custom_vjp inside): fp32 dx/dscale/dbias to 1e-5 absolute and 1e-4
relative (the parameter gradients sum over every row); bf16 inputs with
fp32 parameters (the O5 norms): dx to one bf16 ulp (rtol 1e-2, atol
2e-2), dscale/dbias, fp32 sums of bf16-rounded terms, to 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_ln
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.ops.common import launch_counts

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)


def _inputs(shape, hidden, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(hidden)).astype(np.float32)
    b = (0.1 * rng.randn(hidden)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 32), (1, 1024)])
@pytest.mark.parametrize("rms", [False, True])
def test_affine_output_matches_pallas_fp32(shape, rms):
    hidden = shape[-1]
    x, w, b = _inputs(shape, hidden, seed=hidden + rms)
    if rms:
        want = jax_ln.fused_rms_norm_affine(
            jnp.asarray(x), jnp.asarray(w), (hidden,),
            implementation="pallas")
        got = port_ln.fused_rms_norm_affine(
            torch.from_numpy(x), torch.from_numpy(w), (hidden,))
    else:
        want = jax_ln.fused_layer_norm_affine(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), (hidden,),
            implementation="pallas")
        got = port_ln.fused_layer_norm_affine(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            (hidden,))
    assert got.shape == tuple(shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("rms", [False, True])
def test_row_statistics_match_pallas(rms):
    """``mean``/``invvar`` per row, fp32, kept for the backward."""
    x, w, b = _inputs((9, 48), 48, seed=7)
    want_out, want_mean, want_inv = jax_ln._ln_fwd_pallas(
        jnp.asarray(x), 1e-5, rms)
    y, mean, invvar = port_ln.layer_norm_fwd(
        torch.from_numpy(x), torch.ones(48), None, 1e-5, rms)
    assert mean.dtype == invvar.dtype == torch.float32
    assert mean.shape == invvar.shape == (9,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean),
                               **FP32_TOL)
    np.testing.assert_allclose(invvar.numpy(), np.asarray(want_inv),
                               **FP32_TOL)
    # unit scale, no bias: the output is the normalized row itself
    np.testing.assert_allclose(y.numpy(), np.asarray(want_out), **FP32_TOL)


def test_bf16_rounds_like_pallas():
    x, w, b = _inputs((6, 64), 64, seed=11)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax_ln.fused_layer_norm_affine(
        xb, jnp.asarray(w), jnp.asarray(b), 64, implementation="pallas")
    got = port_ln.fused_layer_norm_affine(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(b), 64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_cpu_path_launches_no_kernel():
    before = launch_counts().get(port_ln.KERNEL, 0)
    x, w, b = _inputs((4, 32), 32, seed=1)
    port_ln.fused_layer_norm_affine(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), 32)
    assert launch_counts().get(port_ln.KERNEL, 0) == before


def test_other_devices_rejected():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_ln.layer_norm_fwd(x, torch.empty(8, device="meta"), None,
                               1e-5, rms=True)


def _vjp_jax(x, w, b, dy, rms, x_dtype):
    args = [jnp.asarray(x, x_dtype), jnp.asarray(w)]
    if rms:
        f = lambda x, w: jax_ln.fused_rms_norm_affine(
            x, w, x.shape[-1], implementation="pallas")
    else:
        args.append(jnp.asarray(b))
        f = lambda x, w, b: jax_ln.fused_layer_norm_affine(
            x, w, b, x.shape[-1], implementation="pallas")
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g.astype(jnp.float32)) for g in
            vjp(jnp.asarray(dy, x_dtype))]


def _vjp_port(x, w, b, dy, rms, x_dtype):
    tx = torch.from_numpy(x).to(x_dtype).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    if rms:
        y = port_ln.fused_rms_norm_affine(tx, tw, x.shape[-1])
        leaves = (tx, tw)
    else:
        tb = torch.from_numpy(b).requires_grad_()
        y = port_ln.fused_layer_norm_affine(tx, tw, tb, x.shape[-1])
        leaves = (tx, tw, tb)
    y.backward(torch.from_numpy(dy).to(x_dtype))
    assert tw.grad.dtype == torch.float32
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_grads_match_jax_vjp(rms, dtype):
    x, w, b = _inputs((6, 5, 64), 64, seed=20 + rms)
    dy = np.random.RandomState(3).randn(6, 5, 64).astype(np.float32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = _vjp_jax(x, w, b, dy, rms, jdt)
    got = _vjp_port(x, w, b, dy, rms, tdt)
    assert len(got) == len(want) == (2 if rms else 3)
    dx_tol = FP32_TOL if dtype == "fp32" else BF16_TOL
    np.testing.assert_allclose(got[0], want[0], **dx_tol, err_msg="dx")
    for name, g, w_ in zip(("dscale", "dbias"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=1e-5, err_msg=name)
