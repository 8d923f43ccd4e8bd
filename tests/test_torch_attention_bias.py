"""The additive-bias instances of the port's attention rungs against the
JAX package's Pallas bodies.

The same numpy q/k/v, output cotangent and bias (and, where a case says
so, segment ids and a dropout seed) go through
``apex_tpu.ops.attention.flash_attention(bias=..., bias_requires_grad=False,
implementation=rung)`` with ``jax.vjp`` (``_short_fwd_kernel``/
``_short_bwd_kernel``, ``_mid_fwd_kernel``/``_mid_bwd_kernel`` or
``_fa_fwd_kernel``/``_fa_bwd_dkv_kernel``/``_fa_bwd_dq_kernel``, each with
``has_bias``, in interpret mode on the CPU) and through the port's
``flash_attention`` on CPU tensors with ``torch.autograd`` (the CUDA
kernels' plain versions).  The biases: ``shared`` ``(1, 1, sq, sk)``,
``per_batch`` ``(b, 1, sq, sk)``, ``per_head`` ``(b, h, sq, sk)`` and a 2-D
``(sq, sk)``, each with some entries at -1e30 (a boolean mask turned into
a bias, as contrib attention makes it).  The bias's gradient is exactly
zero in both packages.

Tolerances: fp32 products on both sides, so outputs agree to 1e-5 and
gradients (sums of up to s products in another order) to 5e-5, relative
and absolute, as ``tests/test_torch_attention_segments.py`` holds the
segment instances; bf16: 3 bf16 ulps at each output's largest magnitude.
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
RATE, SEED = 0.1, 0xB1A5
BIAS_SHAPES = {"shared": (1, 1), "per_batch": (B, 1), "per_head": (B, H),
               "2d": ()}


def make_bias(kind, sq, sk, seed):
    """A float bias of ``kind``'s shape: normal values plus -1e30 on about
    a tenth of the entries (never a whole row)."""
    rng = np.random.RandomState(seed)
    bias = rng.randn(*BIAS_SHAPES[kind], sq, sk).astype(np.float32)
    masked = rng.rand(*bias.shape) < 0.1
    masked[..., 0] = False
    return np.where(masked, np.float32(-1e30), bias)


def inputs(sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, sq, d).astype(np.float32)
    k, v = (rng.randn(B, H, sk, d).astype(np.float32) for _ in range(2))
    dout = rng.randn(B, H, sq, d).astype(np.float32)
    return q, k, v, dout


def padding_ids(sq, sk):
    """contrib attention's ``key_padding_mask`` as ids: queries 0, keys
    past each row's length -2."""
    lens = np.array([sk, sk * 3 // 5])
    kv = np.where(np.arange(sk)[None] < lens[:, None], 0, -2)
    return np.zeros((B, sq), np.int32), kv.astype(np.int32)


def jax_run(rung, q, k, v, dout, bias, causal, ids=None, drop=False,
            dtype=jnp.float32):
    kw = dict(block_q=64, block_k=64) if rung == "pallas" else {}
    if ids is not None:
        kw.update(q_segment_ids=jnp.asarray(ids[0]),
                  kv_segment_ids=jnp.asarray(ids[1]))
    if drop:
        kw.update(dropout_rate=RATE, dropout_seed=jnp.uint32(SEED))
    f = lambda q, k, v, b: jax_flash_attention(
        q, k, v, causal=causal, bias=b, bias_requires_grad=False,
        implementation=rung, **kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)),
                       jnp.asarray(bias))
    grads = vjp(jnp.asarray(dout, dtype))
    to_np = lambda x: np.asarray(x.astype(jnp.float32))
    return to_np(out), [to_np(g) for g in grads]


def port_run(rung, q, k, v, dout, bias, causal, ids=None, drop=False,
             dtype=torch.float32):
    kw = {}
    if ids is not None:
        kw.update(q_segment_ids=torch.from_numpy(ids[0]),
                  kv_segment_ids=torch.from_numpy(ids[1]))
    if drop:
        kw.update(dropout_rate=RATE, dropout_seed=SEED)
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in (q, k, v))
    b = torch.from_numpy(bias).requires_grad_()
    out = port_attention.flash_attention(
        q, k, v, causal=causal, bias=b, bias_requires_grad=False,
        implementation=rung, **kw)
    out.backward(torch.from_numpy(dout).to(dtype))
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in (q, k, v, b)])


CASES = [  # (rung, sq, sk, d, bias kind, causal, with ids and dropout)
    ("short", 72, 72, 64, "shared", True, False),
    ("short", 40, 56, 128, "per_batch", False, False),
    ("short", 72, 72, 64, "per_head", True, True),
    ("short", 72, 72, 64, "2d", False, True),
    ("mid", 200, 200, 64, "shared", False, True),
    ("mid", 150, 200, 64, "per_batch", False, False),
    ("mid", 200, 200, 128, "per_head", True, False),
    ("mid", 200, 200, 64, "2d", True, True),
    ("pallas", 160, 160, 64, "shared", True, False),
    ("pallas", 100, 130, 64, "per_batch", False, True),
    ("pallas", 160, 160, 64, "per_head", False, True),
    ("pallas", 160, 160, 128, "2d", True, False),
]


@pytest.mark.parametrize("rung, sq, sk, d, kind, causal, extra", CASES)
def test_bias_instance_matches_pallas_fp32(rung, sq, sk, d, kind, causal,
                                           extra):
    seed = sq + sk + d + len(kind) + causal + extra
    q, k, v, dout = inputs(sq, sk, d, seed)
    bias = make_bias(kind, sq, sk, seed)
    ids = padding_ids(sq, sk) if extra else None
    want_out, want_g = jax_run(rung, q, k, v, dout, bias, causal, ids, extra)
    got_out, got_g = port_run(rung, q, k, v, dout, bias, causal, ids, extra)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for name, got, want in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"d{name}")
    # the bias's gradient: a hard zero of its shape in both packages
    assert got_g[3].shape == bias.shape and not got_g[3].any()
    assert want_g[3].shape == bias.shape and not want_g[3].any()


@pytest.mark.parametrize("rung, kind", [("short", "per_head"),
                                        ("mid", "per_batch"),
                                        ("pallas", "shared")])
def test_bias_instance_bf16_band(rung, kind):
    q, k, v, dout = inputs(96, 96, 64, seed=13)
    bias = make_bias(kind, 96, 96, seed=13)
    ids = padding_ids(96, 96)
    want_out, want_g = jax_run(rung, q, k, v, dout, bias, True, ids, True,
                               jnp.bfloat16)
    got_out, got_g = port_run(rung, q, k, v, dout, bias, True, ids, True,
                              torch.bfloat16)
    for got, want in zip([got_out] + got_g[:3], [want_out] + want_g[:3]):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= 3 * ulp


@pytest.mark.parametrize("rung", ["short", "mid", "pallas"])
def test_a_row_the_bias_masks_is_a_uniform_mean(rung):
    """A query row whose every key the bias pushes to -1e30 (a boolean
    ``attn_mask`` row that is all True) is visible to the predicate: its
    output is the mean of V over its keys (the causal ones here), as
    JAX's softmax gives, not the 0 of a row that segment ids hide; the
    gradients match JAX's, whose backward replays the same scores."""
    sq = sk = 80
    q, k, v, dout = inputs(sq, sk, 64, seed=21)
    bias = make_bias("per_batch", sq, sk, seed=21)
    bias[0, 0, 5] = -1e30
    bias[1, 0, 70] = -1e30
    want_out, want_g = jax_run(rung, q, k, v, dout, bias, True)
    got_out, got_g = port_run(rung, q, k, v, dout, bias, True)
    for b, row in ((0, 5), (1, 70)):
        mean = v[b, :, :row + 1].mean(axis=1)
        np.testing.assert_allclose(got_out[b, :, row], mean, **FWD_TOL)
        np.testing.assert_allclose(want_out[b, :, row], mean, **FWD_TOL)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for name, got, want in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("rung", ["short", "mid", "pallas"])
def test_trainable_bias_raises_naming_dbias(rung):
    """Named from when dBias raised naming queue B item 2d; it is ported
    since: a bias that requires grad runs with the default
    ``bias_requires_grad=True`` and gets the plain reference's autograd
    gradient (``tests/test_torch_attention_dbias.py`` holds it against the
    Pallas bodies); a constant bias runs; ``bias_requires_grad=False``
    gives a hard zero, as in JAX."""
    q = torch.randn((1, 2, 24, 64), generator=torch.Generator().manual_seed(3))
    bias = torch.randn((24, 24), generator=torch.Generator().manual_seed(4))
    want = port_attention.mha_reference(q, q, q, bias=bias)
    got = port_attention.flash_attention(q, q, q, bias=bias,
                                         implementation=rung)
    torch.testing.assert_close(got, want, **FWD_TOL)
    trained, ref = (bias.clone().requires_grad_() for _ in range(2))
    port_attention.flash_attention(q, q, q, bias=trained,
                                   implementation=rung).sum().backward()
    port_attention.mha_reference(q, q, q, bias=ref).sum().backward()
    torch.testing.assert_close(trained.grad, ref.grad, **GRAD_TOL)
    assert trained.grad.abs().max() > 0
    got = port_attention.flash_attention(q, q, q, bias=bias.requires_grad_(),
                                         bias_requires_grad=False,
                                         implementation=rung)
    got.sum().backward()
    assert torch.equal(bias.grad, torch.zeros_like(bias))


def test_mid_lse_with_a_bias_matches_pallas():
    """``fmha_mid(return_lse=True)`` with a per-head bias: ``lse`` and the
    gradients through both outputs match the JAX ``_mid_bwd_kernel``."""
    q, k, v, dout = inputs(150, 150, 64, seed=8)
    bias = make_bias("per_head", 150, 150, seed=8)
    dlse = np.random.RandomState(9).randn(B, H, 150).astype(np.float32)

    def jf(q, k, v):
        return jax_fmha_mid(q, k, v, causal=True, bias=jnp.asarray(bias),
                            bias_requires_grad=False,
                            implementation="pallas", return_lse=True)

    (want_out, want_lse), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    want_g = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = port_mid.fmha_mid(tq, tk, tv, causal=True,
                                 bias=torch.from_numpy(bias),
                                 return_lse=True)
    torch.autograd.backward((out, lse), (torch.from_numpy(dout),
                                         torch.from_numpy(dlse)))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               **FWD_TOL)
    for name, t, want in zip("qkv", (tq, tk, tv), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL, err_msg=f"d{name}")


def test_entries_compose_to_autograd_with_a_bias():
    """The short, mid and flash forward/backward entries with a per-batch
    bias compose to what each rung's autograd function returns (the flash
    entries over the flattened layout with ``heads``), and the plain lse
    reference agrees with the forward's lse."""
    q, k, v, dout = inputs(70, 70, 64, seed=4)
    bias = torch.from_numpy(make_bias("per_batch", 70, 70, seed=4))
    ids = padding_ids(70, 70)
    kw = dict(q_segment_ids=torch.from_numpy(ids[0]),
              kv_segment_ids=torch.from_numpy(ids[1]), dropout_rate=RATE,
              dropout_seed=SEED)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    _, grads = port_run("short", q, k, v, dout, bias.numpy(), True, ids,
                        True)
    for fwd, bwd in ((port_short.short_fwd, port_short.short_bwd),
                     (port_mid.mid_fwd, port_mid.mid_bwd)):
        out, lse = fwd(tq, tk, tv, causal=True, bias=bias, **kw)
        want_out, want_lse = port_mid._xla_with_lse(tq, tk, tv, True,
                                                    bias=bias, **kw)
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), **FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **FWD_TOL)
        got = bwd(tq, tk, tv, out, tdo, lse, causal=True, bias=bias, **kw)
        for g, want in zip(got, grads):
            np.testing.assert_allclose(g.numpy(), want, **GRAD_TOL)
    flat = [t.reshape(B * H, 70, 64) for t in (tq, tk, tv, tdo)]
    out, lse = port_flash.flash_fwd(*flat[:3], causal=True, heads=H,
                                    bias=bias, **kw)
    delta = port_flash.flash_delta(out, flat[3])
    dk, dv = port_flash.flash_bwd_dkv(*flat, lse, delta, causal=True,
                                      heads=H, bias=bias, **kw)
    dq = port_flash.flash_bwd_dq(*flat, lse, delta, causal=True, heads=H,
                                 bias=bias, **kw)
    for g, want in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(g.reshape(B, H, 70, 64).numpy(), want,
                                   **GRAD_TOL)


def test_bias_slab_keeps_the_broadcast():
    """The kernels' bias operand: fp32, contiguous, the batch and head dims
    kept at 1 where the bias broadcasts them (also by a stride of 0, as
    contrib attention's 2-D mask expanded to ``(b, 1, s, s)``), with 0
    strides; a bias that does not broadcast raises."""
    b, h, sq, sk = 3, 4, 5, 6
    mask = torch.randn(sq, sk, dtype=torch.float64)
    cases = ((mask, (1, 1), (0, 0)),
             (mask.expand(b, 1, sq, sk), (1, 1), (0, 0)),
             (torch.randn(b, 1, sq, sk), (b, 1), (sq * sk, 0)),
             (torch.randn(1, h, sq, sk), (1, h), (0, sq * sk)),
             (torch.randn(b, h, sq, sk), (b, h), (h * sq * sk, sq * sk)),
             (torch.randn(b, h, 1, sk), (b, h), (h * sq * sk, sq * sk)))
    for bias, lead, strides in cases:
        slab = port_short.bias_slab("k", bias, b, h, sq, sk)
        assert slab.dtype == torch.float32 and slab.is_contiguous()
        assert tuple(slab.shape) == lead + (sq, sk)
        assert port_short.bias_operands("k", slab)[1:] == strides
        torch.testing.assert_close(
            slab.expand(b, h, sq, sk), torch.broadcast_to(
                bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape)),
                (b, h, sq, sk)).float())
    assert port_short.bias_operands("k", None) == (None, 0, 0)
    for bad in (torch.zeros(2, 1, sq, sk), torch.zeros(sq, sk + 1),
                torch.zeros(sq, sk, dtype=torch.int32)):
        with pytest.raises(ValueError, match="broadcastable"):
            port_short.bias_slab("k", bad, b, h, sq, sk)


def test_reference_takes_a_bias_as_jax_does():
    from apex_tpu.ops.attention import mha_reference as jax_reference

    q, k, v, _ = inputs(48, 40, 64, seed=9)
    for kind in BIAS_SHAPES:
        bias = make_bias(kind, 48, 40, seed=9)
        want = jax_reference(*map(jnp.asarray, (q, k, v)),
                             bias=jnp.asarray(bias))
        got = port_attention.mha_reference(*map(torch.from_numpy, (q, k, v)),
                                           bias=torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("rung, kind", [("short", "per_head"),
                                        ("mid", "per_batch"),
                                        ("pallas", "shared")])
def test_bias_instance_fp16_band(rung, kind):
    """The bias instances in fp16 (O1-O3) with the key padding and
    dropout beside them: 3 fp16 ulps (2**-10 relative) at each output's
    largest magnitude."""
    q, k, v, dout = inputs(96, 96, 64, seed=14)
    bias = make_bias(kind, 96, 96, seed=14)
    ids = padding_ids(96, 96)
    want_out, want_g = jax_run(rung, q, k, v, dout, bias, True, ids, True,
                               jnp.float16)
    got_out, got_g = port_run(rung, q, k, v, dout, bias, True, ids, True,
                              torch.float16)
    for got, want in zip([got_out] + got_g[:3], [want_out] + want_g[:3]):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 10)
        assert np.abs(got - want).max() <= 3 * ulp
