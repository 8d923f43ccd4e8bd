"""The port's mid-sequence attention against the JAX package.

The same numpy q/k/v and cotangents go through
``apex_tpu.ops.attention_mid.fmha_mid(implementation="pallas")`` and
``jax.vjp`` (``_mid_fwd_kernel`` / ``_mid_bwd_kernel`` in interpret mode
on the CPU) and through ``apex_tpu_torch.ops.attention_mid.fmha_mid`` on
CPU tensors with ``torch.autograd`` (the CUDA kernels' plain versions).

Tolerances: fp32 inputs, fp32 products on both sides (the JAX kernels'
``hi_precision``), so forward and lse agree to 1e-5 and the gradients,
sums of up to s products taken in another order, to 5e-5 absolute and
relative.  bf16: the port rounds the backward's operands ``p`` and
``dz * scale`` to bf16 where the TPU's default precision does, while the
interpret-mode JAX kernel multiplies in fp32 on the CPU, so bf16 is held
to a band of 3 bf16 ulps at the largest magnitude of each output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention_mid import fmha_mid as jax_fmha_mid
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_mid as port_mid

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def _inputs(s, causal_seed, b=1, h=2, d=64, sk=None):
    rng = np.random.RandomState(causal_seed)
    sk = s if sk is None else sk
    q = rng.randn(b, h, s, d).astype(np.float32)
    k, v = (rng.randn(b, h, sk, d).astype(np.float32) for _ in range(2))
    dout = rng.randn(b, h, s, d).astype(np.float32)
    dlse = rng.randn(b, h, s).astype(np.float32)
    return q, k, v, dout, dlse


def _jax(q, k, v, dout, causal, dlse=None, dtype=jnp.float32):
    with_lse = dlse is not None

    def f(q, k, v):
        return jax_fmha_mid(q, k, v, causal=causal, implementation="pallas",
                            return_lse=with_lse)

    res, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    ct = ((jnp.asarray(dout, dtype), jnp.asarray(dlse)) if with_lse
          else jnp.asarray(dout, dtype))
    grads = vjp(ct)
    out, lse = res if with_lse else (res, None)
    to_np = lambda x: None if x is None else np.asarray(x.astype(jnp.float32))
    return to_np(out), to_np(lse), [to_np(g) for g in grads]


def _port(q, k, v, dout, causal, dlse=None, dtype=torch.float32):
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in (q, k, v))
    res = port_mid.fmha_mid(q, k, v, causal=causal,
                            return_lse=dlse is not None)
    out, lse = res if dlse is not None else (res, None)
    outs, cts = [out], [torch.from_numpy(dout).to(dtype)]
    if dlse is not None:
        outs.append(lse)
        cts.append(torch.from_numpy(dlse))
    torch.autograd.backward(outs, cts)
    to_np = lambda x: None if x is None else x.detach().float().numpy()
    return to_np(out), to_np(lse), [to_np(t.grad) for t in (q, k, v)]


@pytest.mark.parametrize("s, causal", [(576, True), (640, False),
                                       (600, True)])
def test_forward_and_grads_match_pallas_fp32(s, causal):
    q, k, v, dout, _ = _inputs(s, s + causal)
    want_out, _, want_g = _jax(q, k, v, dout, causal)
    got_out, _, got_g = _port(q, k, v, dout, causal)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for name, got, want in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"d{name}")


def test_return_lse_with_a_real_lse_cotangent():
    """``dz = p * (dp - delta + dlse)``: both cotangents at once, on a
    ragged causal length."""
    q, k, v, dout, dlse = _inputs(600, 3)
    want_out, want_lse, want_g = _jax(q, k, v, dout, True, dlse)
    got_out, got_lse, got_g = _port(q, k, v, dout, True, dlse)
    assert got_lse.shape == (1, 2, 600)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    np.testing.assert_allclose(got_lse, want_lse, **FWD_TOL)
    for name, got, want in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"d{name}")


def test_cross_attention_ragged_kv():
    q, k, v, dout, _ = _inputs(520, 4, sk=700)
    want_out, _, want_g = _jax(q, k, v, dout, False)
    got_out, _, got_g = _port(q, k, v, dout, False)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for name, got, want in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"d{name}")


def test_bf16_band():
    q, k, v, dout, _ = _inputs(576, 5)
    want_out, _, want_g = _jax(q, k, v, dout, True, dtype=jnp.bfloat16)
    got_out, _, got_g = _port(q, k, v, dout, True, dtype=torch.bfloat16)
    for got, want in zip([got_out] + got_g, [want_out] + want_g):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= 3 * ulp


def test_xla_with_lse_is_the_plain_reference():
    q, k, v, _, _ = _inputs(530, 6)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = port_mid._xla_with_lse(tq, tk, tv, causal=True)
    got_out, got_lse = port_mid.mid_fwd(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got_out.numpy(), out.numpy(), **FWD_TOL)
    np.testing.assert_allclose(got_lse.numpy(), lse.numpy(), **FWD_TOL)


def test_ladder_routes_by_length(monkeypatch):
    calls = []
    for name in ("fmha_short", "fmha_mid"):
        real = getattr(port_attention, name)
        monkeypatch.setattr(
            port_attention, name,
            lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    for s in (512, 513, 600, 2048):
        q = torch.zeros((1, 1, s, 8))
        port_attention.flash_attention(q, q, q, causal=True)
    assert calls == ["fmha_short", "fmha_mid", "fmha_mid", "fmha_mid"]
    # past the mid window the flash rung takes over
    q = torch.zeros((1, 1, 2049, 8))
    port_attention.flash_attention(q, q, q, causal=True)
    assert calls == ["fmha_short", "fmha_mid", "fmha_mid", "fmha_mid"]


def test_mid_window_env_override(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FMHA_MID_MAX_SEQ", "0")
    assert port_mid.mid_seq_threshold() == 0
    q = torch.zeros((1, 1, 600, 8))
    seen = []
    monkeypatch.setattr(port_attention, "fmha_mid",
                        lambda *a, **kw: seen.append("mid"))
    out = port_attention.flash_attention(q, q, q, causal=True)
    assert seen == [] and out.shape == q.shape      # the flash rung
    monkeypatch.setenv("APEX_TPU_FMHA_MID_MAX_SEQ", "4096")
    assert port_mid.mid_seq_threshold() == 4096


def test_forced_rungs_and_unported_features():
    q = torch.randn((1, 1, 40, 8), generator=torch.Generator().manual_seed(0))
    short = port_attention.flash_attention(q, q, q, implementation="short")
    mid = port_attention.flash_attention(q, q, q, implementation="mid")
    flash = port_attention.flash_attention(q, q, q, implementation="pallas")
    np.testing.assert_allclose(mid.numpy(), short.numpy(), **FWD_TOL)
    np.testing.assert_allclose(flash.numpy(), short.numpy(), **FWD_TOL)
    # a constant bias is ported, and a trainable one (dBias) since: its
    # gradient is the plain reference's
    trained, ref = (torch.zeros(40, 40, requires_grad=True) for _ in range(2))
    port_mid.fmha_mid(q, q, q, bias=trained).sum().backward()
    port_attention.mha_reference(q, q, q, bias=ref).sum().backward()
    np.testing.assert_allclose(trained.grad.numpy(), ref.grad.numpy(),
                               **GRAD_TOL)
    bias = torch.randn((40, 40), generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(
        port_mid.fmha_mid(q, q, q, bias=bias).numpy(),
        port_attention.mha_reference(q, q, q, bias=bias).numpy(), **FWD_TOL)
    # dropout, ported since: a seed is required, and every rung draws the
    # reference's mask
    with pytest.raises(ValueError, match="requires dropout_seed"):
        port_mid.fmha_mid(q, q, q, dropout_rate=0.1)
    drop = dict(dropout_rate=0.1, dropout_seed=12345)
    want = port_attention.mha_reference(q, q, q, **drop)
    for rung in ("short", "mid", "pallas"):
        got = port_attention.flash_attention(q, q, q, implementation=rung,
                                             **drop)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_fp16_band():
    """fp16 (the O1-O3 levels): the port rounds ``p`` and ``dz * scale``
    to fp16 where the interpret-mode JAX kernel multiplies in fp32, as in
    bf16, so the outputs are held to 3 fp16 ulps (2**-10 relative) at
    each output's largest magnitude, with a real lse cotangent."""
    q, k, v, dout, dlse = _inputs(576, 9)
    want_out, want_lse, want_g = _jax(q, k, v, dout, True, dlse,
                                      dtype=jnp.float16)
    got_out, got_lse, got_g = _port(q, k, v, dout, True, dlse,
                                    dtype=torch.float16)
    np.testing.assert_allclose(got_lse, want_lse, rtol=1e-3, atol=1e-3)
    for got, want in zip([got_out] + got_g, [want_out] + want_g):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 10)
        assert np.abs(got - want).max() <= 3 * ulp
