"""The port's flash rung against the JAX package's.

The same numpy q/k/v and output cotangent go through
``apex_tpu.ops.attention.flash_attention(implementation="pallas",
block_q=..., block_k=...)`` with ``jax.vjp`` (``_fa_fwd_kernel``,
``_fa_bwd_dkv_kernel`` and ``_fa_bwd_dq_kernel`` in interpret mode on the
CPU) and through ``apex_tpu_torch.ops.attention.flash_attention(
implementation="pallas")`` on CPU tensors with ``torch.autograd`` (the
CUDA kernels' plain versions).  The shapes are those of
``tests/test_softmax_attention.py``'s flash tests: 128 tokens in 64-row
blocks, and 100 queries against 72 keys, which the JAX wrapper pads to
its blocks and masks (the port's kernels mask the ragged ends
themselves).

Tolerances: fp32 inputs with fp32 products on both sides (the JAX
kernels' ``hi_precision``), so outputs agree to 1e-5 and gradients, sums
of up to s products in another order, to 5e-5, relative and absolute.
bf16: the port rounds ``q * scale``, ``p`` and ``dz * scale`` to bf16 as
product operands (as the tensor cores and the TPU's default precision
do), while the interpret-mode JAX kernels multiply in fp32, so bf16 is
held to 3 bf16 ulps at the largest magnitude of each output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import flash_attention as jax_flash_attention
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_flash as port_flash
from apex_tpu_torch.ops import attention_mid as port_mid

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def _inputs(sq, sk, d, seed, b=1, h=2):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    dout = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, dout


def _jax(q, k, v, dout, causal, dtype=jnp.float32, block=64):
    f = lambda q, k, v: jax_flash_attention(
        q, k, v, causal=causal, block_q=block, block_k=block,
        implementation="pallas")
    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(dout, dtype))
    to_np = lambda x: np.asarray(x.astype(jnp.float32))
    return to_np(out), [to_np(g) for g in grads]


def _port(q, k, v, dout, causal, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in (q, k, v))
    out = port_attention.flash_attention(q, k, v, causal=causal,
                                         implementation="pallas", **kw)
    out.backward(torch.from_numpy(dout).to(dtype))
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in (q, k, v)])


@pytest.mark.parametrize("sq, sk, d, causal", [
    (128, 128, 128, True), (128, 128, 128, False), (100, 72, 128, False),
    (100, 72, 64, True), (72, 100, 64, True)])
def test_forward_and_grads_match_pallas_fp32(sq, sk, d, causal):
    q, k, v, dout = _inputs(sq, sk, d, seed=sq + sk + causal)
    want_out, want_g = _jax(q, k, v, dout, causal)
    got_out, got_g = _port(q, k, v, dout, causal)
    assert got_out.shape == (1, 2, sq, d)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for name, got, want in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_band(causal):
    q, k, v, dout = _inputs(100, 100, 64, seed=7 + causal)
    want_out, want_g = _jax(q, k, v, dout, causal, dtype=jnp.bfloat16)
    got_out, got_g = _port(q, k, v, dout, causal, dtype=torch.bfloat16)
    for got, want in zip([got_out] + got_g, [want_out] + want_g):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= 3 * ulp


def test_lse_is_the_plain_reference():
    """The flat forward's lse against the plain masked-score formula."""
    q, k, v, _ = _inputs(90, 130, 64, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = port_flash.flash_fwd(tq[0], tk[0], tv[0], causal=True)
    want_out, want_lse = port_mid._xla_with_lse(tq, tk, tv, causal=True)
    assert lse.shape == (2, 90) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out[0].numpy(), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse[0].numpy(), **FWD_TOL)


def test_backward_entries_compose_to_autograd():
    """``flash_bwd_dkv`` and ``flash_bwd_dq`` from ``delta = rowsum(dout *
    out)`` are what the autograd function returns."""
    q, k, v, dout = _inputs(70, 70, 64, seed=4)
    tq, tk, tv, tdo = (torch.from_numpy(x)[0] for x in (q, k, v, dout))
    out, lse = port_flash.flash_fwd(tq, tk, tv, causal=True)
    delta = port_flash.flash_delta(out, tdo)
    dk, dv = port_flash.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta,
                                      causal=True)
    dq = port_flash.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal=True)
    _, grads = _port(q, k, v, dout, True)
    for got, want in zip((dq, dk, dv), grads):
        np.testing.assert_array_equal(got.numpy(), want[0])


def test_ladder_routes_by_length(monkeypatch):
    calls = []
    for name in ("fmha_short", "fmha_mid", "_flash_attention_kernels"):
        real = getattr(port_attention, name)
        monkeypatch.setattr(
            port_attention, name,
            lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    for s in (2048, 2049):
        q = torch.zeros((1, 1, s, 8))
        port_attention.flash_attention(q, q, q, causal=True)
    assert calls == ["fmha_mid", "_flash_attention_kernels"]
    # with the thresholds set low, as the tiny-model tests run the rungs
    calls.clear()
    monkeypatch.setenv("APEX_TPU_FMHA_SHORT_MAX_SEQ", "16")
    monkeypatch.setenv("APEX_TPU_FMHA_MID_MAX_SEQ", "32")
    for sq, sk in ((16, 16), (17, 16), (32, 8), (33, 33), (8, 40)):
        port_attention.flash_attention(torch.zeros((1, 1, sq, 8)),
                                       torch.zeros((1, 1, sk, 8)),
                                       torch.zeros((1, 1, sk, 8)))
    assert calls == ["fmha_short", "fmha_mid", "fmha_mid",
                     "_flash_attention_kernels", "_flash_attention_kernels"]
    # 0 turns the mid rung off: everything past the short rung is flash
    calls.clear()
    monkeypatch.setenv("APEX_TPU_FMHA_MID_MAX_SEQ", "0")
    q = torch.zeros((1, 1, 20, 8))
    port_attention.flash_attention(q, q, q, causal=True)
    assert calls == ["_flash_attention_kernels"]


def test_flash_rung_matches_the_other_rungs_and_takes_block_sizes():
    """Forced ``"pallas"`` computes what the mid rung does (fp32, the
    same scale order up to rounding), and the JAX TPU tile arguments
    change nothing."""
    q = torch.randn((2, 2, 50, 64), generator=torch.Generator().manual_seed(5))
    flash = port_attention.flash_attention(q, q, q, causal=True,
                                           implementation="pallas")
    mid = port_attention.flash_attention(q, q, q, causal=True,
                                         implementation="mid")
    tiles = port_attention.flash_attention(q, q, q, causal=True,
                                           implementation="pallas",
                                           block_q=512, block_k=1024)
    np.testing.assert_allclose(flash.numpy(), mid.numpy(), **FWD_TOL)
    assert torch.equal(flash, tiles)
    with pytest.raises(ValueError, match="implementation"):
        port_attention.flash_attention(q, q, q, implementation="xla")


def test_flat_entries_check_their_operands():
    x = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="b\\*h, s, d"):
        port_flash.flash_fwd(x, x, x)
    q, k = torch.zeros((2, 8, 64)), torch.zeros((2, 8, 32))
    with pytest.raises(ValueError, match="b\\*h, s, d"):
        port_flash.flash_fwd(q, k, k)


@pytest.mark.parametrize("causal", [True, False])
def test_fp16_band(causal):
    """fp16 (the O1-O3 levels): the port rounds ``q * scale``, ``p`` and
    ``dz * scale`` to fp16 where the interpret-mode JAX kernels multiply
    in fp32, as in bf16: 3 fp16 ulps (2**-10 relative) at each output's
    largest magnitude."""
    q, k, v, dout = _inputs(100, 100, 64, seed=17 + causal)
    want_out, want_g = _jax(q, k, v, dout, causal, dtype=jnp.float16)
    got_out, got_g = _port(q, k, v, dout, causal, dtype=torch.float16)
    for got, want in zip([got_out] + got_g, [want_out] + want_g):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 10)
        assert np.abs(got - want).max() <= 3 * ulp
