"""The segment-id variants of the port's attention rungs against the JAX
package's Pallas bodies.

The same numpy q/k/v, output cotangent and segment ids go through
``apex_tpu.ops.attention.flash_attention(implementation=rung)`` with
``jax.vjp`` (``_short_fwd_kernel``/``_short_bwd_kernel``,
``_mid_fwd_kernel``/``_mid_bwd_kernel`` or ``_fa_fwd_kernel``/
``_fa_bwd_dkv_kernel``/``_fa_bwd_dq_kernel``, each with ``has_segs``, in
interpret mode on the CPU) and through the port's ``flash_attention(
implementation=rung)`` on CPU tensors with ``torch.autograd`` (the CUDA
kernels' plain versions).  The masks:

- ``ragged``: BERT's padding, every query segment 0 and each row's keys
  past its length -2 (``BertModel._kv_segments``);
- ``packed``: several documents a row, equal ids on both sides;
- ``fmha``: ``contrib.fmha``'s padding, padded queries -1 and padded keys
  -2, so a padded query row sees no key: its output and every gradient
  it feeds are exactly 0, in both packages;
- ``causal``: packed documents under the causal mask.

The JAX wrappers pad to their block multiples (q ids with 0, kv ids with
-1 or -2) and the port pads nothing; both give the same function.
Tolerances: fp32 products on both sides, so outputs agree to 1e-5 and
gradients (sums of up to s products in another order) to 5e-5, relative
and absolute.  bf16: 3 bf16 ulps at each output's largest magnitude, as
``tests/test_torch_attention_flash.py`` holds the flash rung.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import flash_attention as jax_flash_attention
from apex_tpu.ops.attention_mid import fmha_mid as jax_fmha_mid
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_flash as port_flash
from apex_tpu_torch.ops import attention_mid as port_mid
from apex_tpu_torch.ops import attention_short as port_short

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
B, H = 2, 2


def segments(kind, sq, sk, seed):
    """``(q_ids, kv_ids, fully masked query rows)`` of one mask kind,
    ``(B, sq)``/``(B, sk)`` int32."""
    rng = np.random.RandomState(seed)
    if kind in ("ragged", "fmha"):
        lens = np.array([sk, max(1, sk * 3 // 5)])
        kv = np.where(np.arange(sk)[None] < lens[:, None], 0, -2)
        if kind == "ragged":
            q = np.zeros((B, sq), np.int64)
        else:
            q = np.where(np.arange(sq)[None] < lens[:, None], 0, -1)
    else:
        assert sq == sk
        # documents of random lengths, ids counting up along each row
        cuts = [np.sort(rng.choice(np.arange(1, sq), 3, replace=False))
                for _ in range(B)]
        q = np.stack([np.searchsorted(c, np.arange(sq), side="right")
                      for c in cuts])
        kv = q.copy()
    q, kv = q.astype(np.int32), kv.astype(np.int32)
    dead = ~(q[:, :, None] == kv[:, None, :]).any(-1)
    return q, kv, dead


def inputs(sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, sq, d).astype(np.float32)
    k, v = (rng.randn(B, H, sk, d).astype(np.float32) for _ in range(2))
    dout = rng.randn(B, H, sq, d).astype(np.float32)
    return q, k, v, dout


def jax_run(rung, q, k, v, dout, qs, ks, causal, dtype=jnp.float32):
    kw = dict(block_q=64, block_k=64) if rung == "pallas" else {}
    f = lambda q, k, v: jax_flash_attention(
        q, k, v, causal=causal, q_segment_ids=jnp.asarray(qs),
        kv_segment_ids=jnp.asarray(ks), implementation=rung, **kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(dout, dtype))
    to_np = lambda x: np.asarray(x.astype(jnp.float32))
    return to_np(out), [to_np(g) for g in grads]


def port_run(rung, q, k, v, dout, qs, ks, causal, dtype=torch.float32):
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in (q, k, v))
    out = port_attention.flash_attention(
        q, k, v, causal=causal, q_segment_ids=torch.from_numpy(qs),
        kv_segment_ids=torch.from_numpy(ks), implementation=rung)
    out.backward(torch.from_numpy(dout).to(dtype))
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in (q, k, v)])


CASES = [  # (rung, sq, sk, d, kind, causal)
    ("short", 72, 72, 64, "ragged", False),
    ("short", 40, 56, 128, "ragged", False),
    ("short", 72, 72, 64, "packed", False),
    ("short", 72, 72, 64, "fmha", False),
    ("short", 72, 72, 64, "packed", True),
    ("mid", 200, 200, 64, "ragged", False),
    ("mid", 200, 200, 64, "packed", False),
    ("mid", 200, 200, 128, "fmha", False),
    ("mid", 200, 200, 64, "packed", True),
    ("pallas", 160, 160, 64, "ragged", False),
    ("pallas", 100, 130, 64, "ragged", False),
    ("pallas", 160, 160, 64, "packed", False),
    ("pallas", 160, 160, 128, "fmha", False),
    ("pallas", 160, 160, 64, "packed", True),
]


@pytest.mark.parametrize("rung, sq, sk, d, kind, causal", CASES)
def test_segment_variant_matches_pallas_fp32(rung, sq, sk, d, kind, causal):
    seed = sq + sk + d + len(kind) + causal
    q, k, v, dout = inputs(sq, sk, d, seed)
    qs, ks, dead = segments(kind, sq, sk, seed)
    want_out, want_g = jax_run(rung, q, k, v, dout, qs, ks, causal)
    got_out, got_g = port_run(rung, q, k, v, dout, qs, ks, causal)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for name, got, want in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"d{name}")
    if dead.any():
        # a query that sees no key: out 0 and dq 0 exactly, in both
        rows = np.broadcast_to(dead[:, None], (B, H, sq))
        for name, got, want in (("out", got_out, want_out),
                                ("dq", got_g[0], want_g[0])):
            assert not np.abs(got[rows]).any(), name
            assert not np.abs(want[rows]).any(), name


@pytest.mark.parametrize("rung", ["short", "mid", "pallas"])
def test_segment_variant_bf16_band(rung):
    q, k, v, dout = inputs(96, 96, 64, seed=11)
    qs, ks, _ = segments("fmha", 96, 96, seed=11)
    want_out, want_g = jax_run(rung, q, k, v, dout, qs, ks, False,
                               jnp.bfloat16)
    got_out, got_g = port_run(rung, q, k, v, dout, qs, ks, False,
                              torch.bfloat16)
    for got, want in zip([got_out] + got_g, [want_out] + want_g):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= 3 * ulp


@pytest.mark.parametrize("kind", ["packed", "fmha"])
def test_mid_lse_and_its_cotangent_match_pallas(kind):
    """``fmha_mid(return_lse=True)`` with segment ids: ``lse`` and the
    gradients through both outputs (the backward's lse cotangent) match
    the JAX ``_mid_bwd_kernel``; a dead row's lse is about -1e30 in
    both."""
    q, k, v, dout = inputs(150, 150, 64, seed=5)
    qs, ks, dead = segments(kind, 150, 150, seed=5)
    dlse = np.random.RandomState(6).randn(B, H, 150).astype(np.float32)

    def jf(q, k, v):
        return jax_fmha_mid(q, k, v, q_segment_ids=jnp.asarray(qs),
                            kv_segment_ids=jnp.asarray(ks),
                            implementation="pallas", return_lse=True)

    (want_out, want_lse), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    want_g = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = port_mid.fmha_mid(tq, tk, tv, q_segment_ids=torch.from_numpy(qs),
                                 kv_segment_ids=torch.from_numpy(ks),
                                 return_lse=True)
    torch.autograd.backward((out, lse), (torch.from_numpy(dout),
                                         torch.from_numpy(dlse)))
    live = ~np.broadcast_to(dead[:, None], (B, H, 150))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy()[live],
                               np.asarray(want_lse)[live], **FWD_TOL)
    assert (lse.detach().numpy()[~live] < -1e29).all()
    assert (np.asarray(want_lse)[~live] < -1e29).all()
    for name, t, want in zip("qkv", (tq, tk, tv), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL, err_msg=f"d{name}")


def test_entries_compose_to_autograd_with_segments():
    """The short, mid and flash forward/backward entries with ids compose
    to what each rung's autograd function returns (the flash entries over
    the flattened layout with ``heads``), and the plain lse reference
    agrees with the forward's lse."""
    q, k, v, dout = inputs(70, 70, 64, seed=4)
    qs, ks, _ = segments("packed", 70, 70, seed=4)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    ids = dict(q_segment_ids=torch.from_numpy(qs),
               kv_segment_ids=torch.from_numpy(ks))
    _, grads = port_run("short", q, k, v, dout, qs, ks, True)
    for fwd, bwd in ((port_short.short_fwd, port_short.short_bwd),
                     (port_mid.mid_fwd, port_mid.mid_bwd)):
        out, lse = fwd(tq, tk, tv, causal=True, **ids)
        want_out, want_lse = port_mid._xla_with_lse(tq, tk, tv, True, **ids)
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), **FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **FWD_TOL)
        got = bwd(tq, tk, tv, out, tdo, lse, causal=True, **ids)
        for g, want in zip(got, grads):
            np.testing.assert_allclose(g.numpy(), want, **GRAD_TOL)
    flat = [t.reshape(B * H, 70, 64) for t in (tq, tk, tv, tdo)]
    out, lse = port_flash.flash_fwd(*flat[:3], causal=True, heads=H, **ids)
    delta = port_flash.flash_delta(out, flat[3])
    dk, dv = port_flash.flash_bwd_dkv(*flat, lse, delta, causal=True,
                                      heads=H, **ids)
    dq = port_flash.flash_bwd_dq(*flat, lse, delta, causal=True, heads=H,
                                 **ids)
    for g, want in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(g.reshape(B, H, 70, 64).numpy(), want,
                                   **GRAD_TOL)


def test_reference_takes_segment_ids_as_jax_does():
    from apex_tpu.ops.attention import mha_reference as jax_reference

    q, k, v, _ = inputs(48, 48, 64, seed=9)
    for kind in ("ragged", "packed", "fmha"):
        qs, ks, _ = segments(kind, 48, 48, seed=9)
        want = jax_reference(*map(jnp.asarray, (q, k, v)), causal=True,
                             q_segment_ids=jnp.asarray(qs),
                             kv_segment_ids=jnp.asarray(ks))
        got = port_attention.mha_reference(
            *map(torch.from_numpy, (q, k, v)), causal=True,
            q_segment_ids=torch.from_numpy(qs),
            kv_segment_ids=torch.from_numpy(ks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_segment_ids_are_checked():
    q = torch.zeros((2, 2, 8, 64))
    ids = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="both q and kv"):
        port_attention.flash_attention(q, q, q, q_segment_ids=ids)
    for rung in ("short", "mid", "pallas"):
        with pytest.raises(ValueError, match="kv_segment_ids of shape"):
            port_attention.flash_attention(
                q, q, q, q_segment_ids=ids, kv_segment_ids=ids[:, :5],
                implementation=rung)
        with pytest.raises(ValueError, match="integers"):
            port_attention.flash_attention(
                q, q, q, q_segment_ids=ids.float(), kv_segment_ids=ids,
                implementation=rung)
    with pytest.raises(ValueError, match="heads dividing"):
        port_flash.flash_fwd(q.reshape(4, 8, 64), q.reshape(4, 8, 64),
                             q.reshape(4, 8, 64), q_segment_ids=ids,
                             kv_segment_ids=ids, heads=3)


@pytest.mark.parametrize("rung, d", [("short", 16), ("mid", 32),
                                     ("pallas", 16), ("pallas", 96)])
def test_head_dims_the_kernels_do_not_take_are_padded(monkeypatch, rung, d):
    """A head dim under 128 other than 64 reaches the kernels zero-padded
    to 64 or 128 (as the JAX flash wrapper pads to its 128 lanes), with
    the original dim's scale; outputs and gradients are the plain
    reference's (the fine-tuning example's BERT has head dim 16)."""
    seen = []
    # the forward runner each rung's autograd function calls
    entry = {"short": (port_short, "_run_fwd"), "mid": (port_mid, "_run_fwd"),
             "pallas": (port_attention, "flash_run_fwd")}[rung]
    real = getattr(*entry)
    monkeypatch.setattr(*entry, lambda q, *a, **kw: seen.append(q.shape[-1])
                        or real(q, *a, **kw))
    q, k, v, dout = inputs(40, 40, d, seed=d)
    qs, ks, _ = segments("packed", 40, 40, seed=d)
    got_out, got_g = port_run(rung, q, k, v, dout, qs, ks, True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    want = port_attention.mha_reference(
        tq, tk, tv, causal=True, q_segment_ids=torch.from_numpy(qs),
        kv_segment_ids=torch.from_numpy(ks))
    want.backward(torch.from_numpy(dout))
    assert seen == [64 if d < 64 else 128] and got_out.shape[-1] == d
    np.testing.assert_allclose(got_out, want.detach().numpy(), **FWD_TOL)
    for got, t in zip(got_g, (tq, tk, tv)):
        np.testing.assert_allclose(got, t.grad.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("rung", ["short", "mid", "pallas"])
def test_segment_variant_fp16_band(rung):
    """The segment instances in fp16 (O1-O3), fmha's padding with rows
    that see no key: 3 fp16 ulps (2**-10 relative) at each output's
    largest magnitude, as the bf16 band is 3 bf16 ulps."""
    q, k, v, dout = inputs(96, 96, 64, seed=12)
    qs, ks, _ = segments("fmha", 96, 96, seed=12)
    want_out, want_g = jax_run(rung, q, k, v, dout, qs, ks, False,
                               jnp.float16)
    got_out, got_g = port_run(rung, q, k, v, dout, qs, ks, False,
                              torch.float16)
    for got, want in zip([got_out] + got_g, [want_out] + want_g):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 10)
        assert np.abs(got - want).max() <= 3 * ulp
