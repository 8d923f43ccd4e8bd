"""The port's short-sequence attention against the JAX package.

The same numpy q/k/v (and output cotangent) go through
``apex_tpu.ops.attention_short.fmha_short`` with
``implementation="pallas"`` (``_short_fwd_kernel`` and, through
``jax.vjp``, ``_short_bwd_kernel`` in interpret mode on the CPU) and
through ``apex_tpu_torch.ops.attention_short`` on CPU tensors (the CUDA
kernels' plain versions, the backward through ``torch.autograd``).

Tolerance: fp32 inputs, fp32 products on both sides (the JAX kernel's
``hi_precision`` for fp32), so outputs agree to 1e-5 absolute and
relative, gradients (sums of up to s products) to 5e-5: the rounding of
fp32 sums taken in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention_short import fmha_short as jax_fmha_short
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_short as port_short

torch.set_num_threads(1)  # the suite's parallel workers share the cores

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def _qkv(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("s", [1, 37, 128, 512])
def test_causal_matches_pallas_fp32(s):
    q, k, v = _qkv(1, 2, s, 64, seed=s)
    want = jax_fmha_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, implementation="pallas")
    got = port_short.fmha_short(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_non_causal_with_scale_matches_pallas_fp32():
    q, k, v = _qkv(2, 2, 40, 32, seed=5)
    want = jax_fmha_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, sm_scale=0.3,
                          implementation="pallas")
    got = port_short.fmha_short(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False,
                                sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lse_is_row_logsumexp():
    """``short_fwd`` keeps the row logsumexp (fp32) for the backward."""
    q, k, v = _qkv(1, 2, 37, 64, seed=2)
    _, lse = port_short.short_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(64.0)
    s = np.where(np.tril(np.ones((37, 37), bool)), s, -np.inf)
    m = s.max(-1)
    want = m + np.log(np.exp(s - m[..., None]).sum(-1))
    assert lse.shape == (1, 2, 37) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


def test_ladder_routes_short_and_matches_reference():
    q, k, v = _qkv(1, 2, 64, 32, seed=9)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = port_attention.flash_attention(tq, tk, tv, causal=True)
    want = port_attention.mha_reference(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_ladder_rejects_what_is_not_ported():
    """Named from when a trainable bias (dBias) raised naming queue B;
    segment ids, dropout, a constant bias and a trainable one, ported
    since, run as the plain reference does (dropout without a seed is a
    ``ValueError``, as in JAX)."""
    q = torch.randn((1, 1, 8, 32), generator=torch.Generator().manual_seed(1))
    ids = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 2]], dtype=torch.int32)
    got = port_attention.flash_attention(q, q, q, q_segment_ids=ids,
                                         kv_segment_ids=ids)
    want = port_attention.mha_reference(q, q, q, q_segment_ids=ids,
                                        kv_segment_ids=ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    trained, ref = (torch.zeros(8, 8, requires_grad=True) for _ in range(2))
    port_attention.flash_attention(q, q, q, bias=trained).sum().backward()
    port_attention.mha_reference(q, q, q, bias=ref).sum().backward()
    np.testing.assert_allclose(trained.grad.numpy(), ref.grad.numpy(),
                               **GRAD_TOL)
    bias = torch.randn((8, 8), generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(
        port_attention.flash_attention(q, q, q, bias=bias).numpy(),
        port_attention.mha_reference(q, q, q, bias=bias).numpy(), **TOL)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        port_attention.flash_attention(q, q, q, dropout_rate=0.1)
    got = port_attention.flash_attention(q, q, q, dropout_rate=0.1,
                                         dropout_seed=0x80000003)
    want = port_attention.mha_reference(q, q, q, dropout_rate=0.1,
                                        dropout_seed=0x80000003)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert not np.allclose(got.numpy(), port_attention.mha_reference(
        q, q, q).numpy())


@pytest.mark.parametrize("s, causal", [(37, True), (200, True), (130, False)])
def test_backward_matches_pallas_vjp_fp32(s, causal):
    q, k, v = _qkv(1, 2, s, 64, seed=100 + s)
    dout = np.random.RandomState(s).randn(1, 2, s, 64).astype(np.float32)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_fmha_short(q, k, v, causal=causal,
                                       implementation="pallas"),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_g = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = port_short.fmha_short(tq, tk, tv, causal=causal)
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, t, w in zip("qkv", (tq, tk, tv), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=f"d{name}")


def test_short_bwd_scales_after_the_product():
    """``short_bwd`` replays ``s = (q . k) * scale`` (the forward scales q
    first); with a non-default scale both stay consistent with autograd
    through the plain math."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 24, 32, seed=8))
    dout = torch.from_numpy(
        np.random.RandomState(8).randn(1, 2, 24, 32).astype(np.float32))
    out, lse = port_short.short_fwd(q, k, v, causal=True, sm_scale=0.3)
    dq, dk, dv = port_short.short_bwd(q, k, v, out, dout, lse, causal=True,
                                      sm_scale=0.3)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = port_attention.mha_reference(tq, tk, tv, causal=True, sm_scale=0.3)
    ref.backward(dout)
    for got, t in zip((dq, dk, dv), (tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("s, causal", [(37, True), (200, True), (130, False)])
def test_fp16_band(s, causal):
    """fp16 (the O1-O3 levels) through the Pallas kernels in interpret
    mode and the port's plain versions: the port rounds ``p`` and ``dz *
    scale`` to fp16 where the interpret-mode JAX kernel multiplies in
    fp32, so the output and the gradients are held to 3 fp16 ulps
    (2**-10 relative) at each one's largest magnitude."""
    q, k, v = _qkv(1, 2, s, 64, seed=300 + s)
    dout = np.random.RandomState(s + 1).randn(1, 2, s, 64).astype(np.float32)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_fmha_short(q, k, v, causal=causal,
                                       implementation="pallas"),
        *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    want_g = vjp(jnp.asarray(dout, jnp.float16))
    tq, tk, tv = (torch.from_numpy(x).half().requires_grad_()
                  for x in (q, k, v))
    got = port_short.fmha_short(tq, tk, tv, causal=causal)
    got.backward(torch.from_numpy(dout).half())
    assert got.dtype == torch.float16
    for g, w in zip([got] + [t.grad for t in (tq, tk, tv)],
                    [want] + list(want_g)):
        w = np.asarray(w.astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 10)
        assert np.abs(g.detach().float().numpy() - w).max() <= 3 * ulp
