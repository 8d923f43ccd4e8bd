"""Dropout in the port against the JAX package: the hidden-dropout op,
the attention keep mask, every attention rung's dropout instance, and the
GPT trained with a key.

- Hidden dropout (``ops.dropout``): the JAX GPT's ``where(bernoulli(key,
  1 - p, shape), x / (1 - p), 0)`` evaluated eagerly in JAX and through
  the port's op on CPU tensors (the Triton kernel's plain version); mask,
  output and gradient are compared bit for bit, in fp32 and bf16.
- The attention mask: ``keep_mask`` against the JAX ``_keep_mask``, bit
  for bit, for random seeds (top bit set too), batch*head rows and
  positions.
- Each rung with dropout: the same numpy q/k/v, cotangent, segment ids
  and seed through ``apex_tpu.ops.attention.flash_attention(
  implementation=rung)`` (the Pallas bodies with ``has_dropout``, in
  interpret mode) and the port's ``flash_attention`` on CPU tensors
  (the CUDA kernels' plain versions), with ``jax.vjp`` and autograd.
  Tolerances as ``tests/test_torch_attention_segments.py`` holds the
  segment instances: fp32 products on both sides, outputs to 1e-5 and
  gradients to 5e-5 (relative and absolute); bf16 to 3 bf16 ulps at each
  output's largest magnitude.  The three port rungs agree with each
  other to the same tolerances (they draw one mask).
- The GPT (2 layers, hidden 64, 2 heads, vocab 256) with
  ``hidden_dropout = attention_dropout = 0.1``: the port's ``loss(...,
  rng=key)`` and its gradients against JAX ``GPTModel.loss(params,
  tokens, targets, rng)`` in a one-device ``shard_map``, at fp32 to the
  tolerances of ``tests/test_torch_gpt_train.py`` (JAX's ``jit`` turns
  the fp32 hidden division into a multiply by its reciprocal, one fp32
  ulp away); at O5 every hidden mask and output in the model is
  bit-identical to JAX's eager formula and the loss sits within the
  bf16 band of ``tests/test_torch_gpt_train.py`` (0.02, each gradient
  within 3% of its norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu._compat
from apex_tpu.amp.policy import get_policy as jax_get_policy
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.ops.attention import _keep_mask, _keep_threshold
from apex_tpu.ops.attention import flash_attention as jax_flash_attention
from apex_tpu.ops.attention_mid import fmha_mid as jax_fmha_mid
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.tensor_parallel.random import (
    data_parallel_key as jax_dp_key,
    model_parallel_key as jax_mp_key,
)
from apex_tpu_torch import convert
from apex_tpu_torch import random as R
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_mid as port_mid
from apex_tpu_torch.ops import attention_short as port_short
from apex_tpu_torch.ops import dropout as port_dropout

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
B, H = 2, 2
RATE = 0.1


def bits_of(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def to_np(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bf16 as ``ml_dtypes.bfloat16`` (as JAX
    gives it)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


# ------------------------------------------------------- hidden dropout

def jax_hidden(x, key, rate):
    """The JAX GPT's hidden dropout (gpt.py:806-808), eagerly."""
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 37, 64), (1000,)])
def test_hidden_dropout_matches_jax_bit_for_bit(dtype, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(123), 1)
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape)
                         .astype(np.float32)).to(dtype)
    xj = jnp.asarray(to_np(x))
    want = np.asarray(jax_hidden(xj, key, RATE))
    got = port_dropout.dropout_fwd(x, np.asarray(key), RATE)
    assert got.dtype == dtype
    np.testing.assert_array_equal(bits_of(to_np(got)), bits_of(want))
    keep = port_dropout.dropout_mask(np.asarray(key), shape, RATE, "cpu")
    np.testing.assert_array_equal(
        keep.numpy(), np.asarray(jax.random.bernoulli(key, 0.9, shape)))
    # about 10% dropped
    assert 0.05 < 1.0 - keep.float().mean().item() < 0.15


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hidden_dropout_gradient_matches_jax(dtype):
    key = jax.random.PRNGKey(9)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(4, 33).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rs.randn(4, 33).astype(np.float32)).to(dtype)
    _, vjp = jax.vjp(lambda a: jax_hidden(a, key, RATE),
                     jnp.asarray(to_np(x)))
    (want,) = vjp(jnp.asarray(to_np(g)))
    xt = x.clone().requires_grad_()
    port_dropout.dropout(xt, np.asarray(key), RATE).backward(g)
    np.testing.assert_array_equal(bits_of(to_np(xt.grad)),
                                  bits_of(np.asarray(want)))


def test_bf16_hidden_scale_is_a_division_by_the_rounded_keep():
    """In bf16 JAX divides by ``bf16(0.9) = 0.8984375``; a multiply by
    ``1 / 0.9`` gives other bits, so the port must divide."""
    assert port_dropout.divisor(RATE, torch.bfloat16) == 0.8984375
    assert port_dropout.divisor(RATE, torch.float32) == float(np.float32(0.9))
    x = torch.from_numpy(np.random.RandomState(2).randn(4096)
                         .astype(np.float32)).to(torch.bfloat16)
    key = R.PRNGKey(4)
    got = port_dropout.dropout_fwd(x, key, RATE)
    keep = port_dropout.dropout_mask(key, x.shape, RATE, "cpu")
    div = (x.float() / 0.8984375).to(torch.bfloat16)
    mul = (x.float() * np.float32(1.0 / 0.9)).to(torch.bfloat16)
    assert torch.equal(got, torch.where(keep, div, 0.0).to(torch.bfloat16))
    assert (div != mul)[keep].any()


def test_dropout_op_edges():
    x = torch.randn(8)
    assert port_dropout.dropout(x, R.PRNGKey(0), 0.0) is x
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError):
            port_dropout.dropout_fwd(x, R.PRNGKey(0), rate)
    # the backward regenerates the mask from the key: no tensor saved
    xt = x.clone().requires_grad_()
    y = port_dropout.dropout(xt, R.PRNGKey(0), RATE)
    assert y.grad_fn.saved_tensors == ()


# ------------------------------------------------------------ keep mask

@pytest.mark.parametrize("seed", [0, 1, 0x80000001, 0xFFFFFFFF, 0x9E3779B9,
                                  123456789])
def test_keep_mask_matches_jax(seed):
    rs = np.random.RandomState(seed % 1000)
    bh = rs.randint(0, 5000, (3, 1, 1)).astype(np.int32)
    qi = rs.randint(0, 9000, (1, 17, 1)).astype(np.int32)
    ki = rs.randint(0, 9000, (1, 1, 19)).astype(np.int32)
    thr = _keep_threshold(RATE)
    assert port_attention.keep_threshold(RATE) == thr
    want = np.asarray(_keep_mask(jnp.uint32(seed), jnp.asarray(bh),
                                 jnp.asarray(qi), jnp.asarray(ki),
                                 jnp.uint32(thr)))
    got = port_attention.keep_mask(seed, torch.from_numpy(bh),
                                   torch.from_numpy(qi), torch.from_numpy(ki),
                                   thr)
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_rows_numbers_rows_globally_and_chunks(monkeypatch):
    """The chunked mask of every (b, h) row is the one-shot hash over the
    global flattened index."""
    monkeypatch.setattr(port_short, "_KEEP_CHUNK", 50)
    drop = (RATE, 0xDEADBEEF)
    got = port_short.keep_rows(drop, (2, 3), 9, 11, None)
    bh = torch.arange(6)[:, None, None]
    want = port_attention.keep_mask(0xDEADBEEF, bh, torch.arange(9)[:, None],
                                    torch.arange(11)[None, :],
                                    port_attention.keep_threshold(RATE))
    assert torch.equal(got, want.reshape(2, 3, 9, 11))


# ---------------------------------------------------------------- rungs

def segments(kind, sq, sk):
    if kind is None:
        return None, None, np.zeros((B, sq), bool)
    if kind == "fmha":
        lens = np.array([sk, max(1, sk * 3 // 5)])
        kv = np.where(np.arange(sk)[None] < lens[:, None], 0, -2)
        q = np.where(np.arange(sq)[None] < lens[:, None], 0, -1)
    else:  # packed documents
        rng = np.random.RandomState(sq)
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


def jax_run(rung, q, k, v, dout, qs, ks, causal, seed, dtype=jnp.float32):
    kw = dict(block_q=64, block_k=64) if rung == "pallas" else {}
    if qs is not None:
        kw.update(q_segment_ids=jnp.asarray(qs), kv_segment_ids=jnp.asarray(ks))
    f = lambda q, k, v: jax_flash_attention(
        q, k, v, causal=causal, dropout_rate=RATE,
        dropout_seed=jnp.uint32(seed), implementation=rung, **kw)
    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(dout, dtype))
    to32 = lambda x: np.asarray(x.astype(jnp.float32))
    return to32(out), [to32(g) for g in grads]


def port_run(rung, q, k, v, dout, qs, ks, causal, seed, dtype=torch.float32):
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in (q, k, v))
    ids = {} if qs is None else dict(q_segment_ids=torch.from_numpy(qs),
                                     kv_segment_ids=torch.from_numpy(ks))
    out = port_attention.flash_attention(
        q, k, v, causal=causal, dropout_rate=RATE, dropout_seed=seed,
        implementation=rung, **ids)
    out.backward(torch.from_numpy(dout).to(dtype))
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in (q, k, v)])


CASES = [  # (rung, sq, sk, d, segment kind, causal)
    ("short", 72, 72, 64, None, True),
    ("short", 40, 56, 128, None, False),
    ("short", 100, 100, 64, "fmha", False),
    ("short", 72, 72, 64, "packed", True),
    ("mid", 200, 200, 64, None, True),
    ("mid", 200, 200, 64, None, False),
    ("mid", 200, 200, 128, "fmha", False),
    ("mid", 200, 200, 64, "packed", True),
    ("pallas", 160, 160, 64, None, True),
    ("pallas", 100, 130, 64, None, False),
    ("pallas", 160, 160, 128, "fmha", False),
    ("pallas", 160, 160, 64, "packed", True),
]


@pytest.mark.parametrize("rung, sq, sk, d, kind, causal", CASES)
def test_dropout_variant_matches_pallas_fp32(rung, sq, sk, d, kind, causal):
    base = sq + sk + d + causal
    seed = (0x80000000 | base * 2654435761) & 0xFFFFFFFF  # top bit set
    q, k, v, dout = inputs(sq, sk, d, base)
    qs, ks, dead = segments(kind, sq, sk)
    want_out, want_g = jax_run(rung, q, k, v, dout, qs, ks, causal, seed)
    got_out, got_g = port_run(rung, q, k, v, dout, qs, ks, causal, seed)
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
def test_dropout_variant_bf16_band(rung):
    q, k, v, dout = inputs(96, 96, 64, seed=13)
    qs, ks, _ = segments("fmha", 96, 96)
    want_out, want_g = jax_run(rung, q, k, v, dout, qs, ks, True, 77,
                               jnp.bfloat16)
    got_out, got_g = port_run(rung, q, k, v, dout, qs, ks, True, 77,
                              torch.bfloat16)
    for got, want in zip([got_out] + got_g, [want_out] + want_g):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= 3 * ulp


@pytest.mark.parametrize("kind, causal", [(None, True), ("packed", False)])
def test_the_three_rungs_draw_one_mask(kind, causal):
    """Short, mid and flash give one function with dropout (every rung
    hashes the global bh and the absolute positions), and so does the
    reference."""
    q, k, v, dout = inputs(150, 150, 64, seed=5)
    qs, ks, _ = segments(kind, 150, 150)
    runs = {r: port_run(r, q, k, v, dout, qs, ks, causal, 0xC0FFEE)
            for r in ("short", "mid", "pallas")}
    for rung in ("mid", "pallas"):
        np.testing.assert_allclose(runs[rung][0], runs["short"][0], **FWD_TOL)
        for got, want in zip(runs[rung][1], runs["short"][1]):
            np.testing.assert_allclose(got, want, **GRAD_TOL)
    ids = {} if qs is None else dict(q_segment_ids=torch.from_numpy(qs),
                                     kv_segment_ids=torch.from_numpy(ks))
    ref = port_attention.mha_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        dropout_rate=RATE, dropout_seed=0xC0FFEE, **ids)
    np.testing.assert_allclose(ref.numpy(), runs["short"][0], **FWD_TOL)


def test_reference_with_dropout_matches_jax():
    from apex_tpu.ops.attention import mha_reference as jax_ref

    q, k, v, _ = inputs(33, 47, 64, seed=8)
    want = np.asarray(jax_ref(*(jnp.asarray(x) for x in (q, k, v)),
                              dropout_rate=RATE,
                              dropout_seed=jnp.uint32(0xFFFFFFFF)))
    got = port_attention.mha_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), dropout_rate=RATE,
        dropout_seed=torch.tensor(-1, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_mid_lse_is_undropped_and_its_cotangent_matches_pallas():
    q, k, v, dout = inputs(200, 200, 64, seed=3)
    dlse = np.random.RandomState(4).randn(B, H, 200).astype(np.float32)
    seed = 0x87654321

    def jf(q, k, v):
        return jax_fmha_mid(q, k, v, causal=True, dropout_rate=RATE,
                            dropout_seed=jnp.uint32(seed), return_lse=True,
                            implementation="pallas")

    (jo, jl), vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = port_mid.fmha_mid(tq, tk, tv, causal=True, dropout_rate=RATE,
                                 dropout_seed=seed, return_lse=True)
    torch.autograd.backward((out, lse), (torch.from_numpy(dout),
                                         torch.from_numpy(dlse)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl),
                               **FWD_TOL)
    # the lse is the one without dropout
    _, plain_lse = port_mid._xla_with_lse(*(torch.from_numpy(x)
                                            for x in (q, k, v)), True)
    np.testing.assert_allclose(lse.detach().numpy(), plain_lse.numpy(),
                               **FWD_TOL)
    for got, want in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_dropout_needs_a_seed_and_a_rate_below_one():
    q = torch.randn((1, 1, 8, 64))
    for fn in (port_attention.flash_attention, port_short.fmha_short,
               port_mid.fmha_mid, port_attention.mha_reference):
        with pytest.raises(ValueError, match="requires dropout_seed"):
            fn(q, q, q, dropout_rate=0.1)
        with pytest.raises(ValueError, match="dropout_rate"):
            fn(q, q, q, dropout_rate=1.0, dropout_seed=1)
        # a seed without a rate changes nothing
        torch.testing.assert_close(fn(q, q, q, dropout_seed=5),
                                   port_attention.mha_reference(q, q, q))


# ------------------------------------------------------------------ GPT

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=2, max_position_embeddings=640)
LLAMA = dict(position_embedding="rope", activation="swiglu",
             normalization="rmsnorm", max_position_embeddings=64)
DROP = dict(hidden_dropout=RATE, attention_dropout=RATE)


@pytest.fixture(scope="module")
def mesh():
    original = apex_tpu._compat.shard_map

    def shard_map(f, mesh, in_specs, out_specs, check=True):
        return original(f, mesh, in_specs, out_specs, check=False)

    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(apex_tpu._compat, "shard_map", shard_map)
        yield parallel_state.initialize_model_parallel(
            devices=jax.devices()[:1])
    parallel_state.destroy_model_parallel()


def models(level="O0", seed=0, remat=True, **kw):
    sizes = {**SIZES, **kw}
    jm = JaxGPTModel(JaxGPTConfig(**sizes, **DROP, remat=False,
                                  policy=jax_get_policy(level)))
    tm = GPTModel(GPTConfig(**sizes, **DROP, remat=remat,
                            policy=get_policy(level)), device="cpu")
    tree = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32)
        .astype(x.dtype), tree)
    tm.load_state_dict(convert.params_from_jax(params))
    return jm, tm, params


def batch(s, b=2, seed=1):
    toks = np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


def jax_loss_grads(mesh, jm, params, toks, tgts, key):
    specs = jm.param_specs()
    f = jax.jit(jax.shard_map(
        lambda p, t, y, r: jax.value_and_grad(jm.loss)(p, t, y, r),
        mesh=mesh, in_specs=(specs, P(), P(), P()), out_specs=(P(), specs),
        check_vma=False))
    loss, grads = f(jax.tree.map(jnp.asarray, params), jnp.asarray(toks),
                    jnp.asarray(tgts), key)
    return float(loss), convert.params_from_jax(jax.tree.map(np.asarray,
                                                             grads))


def port_loss_grads(tm, toks, tgts, key):
    loss = tm.loss(torch.from_numpy(toks), torch.from_numpy(tgts),
                   rng=np.asarray(key))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("s, extra", [(64, {}), (640, {}),
                                      (2560, LLAMA)],
                         ids=["short-64", "mid-640", "llama-flash-2560"])
def test_gpt_loss_and_grads_with_dropout_match_jax_fp32(mesh, s, extra):
    jm, tm, params = models("O0", seed=s, **extra)
    toks, tgts = batch(s, b=2 if s < 512 else 1)
    key = jax.random.PRNGKey(1234 + s)
    want_loss, want_g = jax_loss_grads(mesh, jm, params, toks, tgts, key)
    loss, grads = port_loss_grads(tm, toks, tgts, key)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=name)
    # dropout really ran: without the key the loss is another number
    with torch.no_grad():
        plain = tm.loss(torch.from_numpy(toks), torch.from_numpy(tgts))
    assert abs(plain.item() - loss) > 1e-4


def test_gpt_key_schedule_matches_jax(mesh):
    """The per-layer keys and each layer's attention seed and hidden keys
    are the JAX layer's (gpt.py:770-821), bit for bit."""
    rng = jax.random.PRNGKey(31)

    def schedule(r):
        out = []
        for key in jax.random.split(r, 3):
            akey = jax_mp_key(jax_dp_key(jax.random.fold_in(key, 0)))
            out += [jax.random.bits(akey, dtype=jnp.uint32),
                    jax_dp_key(jax.random.fold_in(key, 1)),
                    jax_dp_key(jax.random.fold_in(key, 2))]
        return out

    f = jax.jit(jax.shard_map(schedule, mesh=mesh, in_specs=P(),
                              out_specs=[P()] * 9, check_vma=False))
    want = [np.asarray(x) for x in f(rng)]
    for i, key in enumerate(R.split(np.asarray(rng), 3)):
        seed, k1, k2 = port_gpt.dropout_keys(key)
        assert seed == int(want[3 * i])
        np.testing.assert_array_equal(k1, want[3 * i + 1])
        np.testing.assert_array_equal(k2, want[3 * i + 2])


def test_gpt_o5_masks_bit_identical_and_loss_in_band(mesh, monkeypatch):
    """At O5 every hidden dropout of the model gives JAX's eager bits on
    its input, and the loss and gradients sit within the bf16 band of
    ``tests/test_torch_gpt_train.py``."""
    jm, tm, params = models("O5", seed=7)
    seen = []
    real = port_gpt.dropout

    def spy(x, key, rate):
        y = real(x, key, rate)
        seen.append((x.detach().clone(), key, rate, y.detach().clone()))
        return y

    monkeypatch.setattr(port_gpt, "dropout", spy)
    toks, tgts = batch(48)
    key = jax.random.PRNGKey(99)
    want_loss, want_g = jax_loss_grads(mesh, jm, params, toks, tgts, key)
    loss, grads = port_loss_grads(tm, toks, tgts, key)
    # 2 layers x 2 sites in the forward, and what the remat recompute
    # replays (it stops after the last tensor the backward needs)
    assert len(seen) >= 4
    for x, k, rate, y in seen:
        assert x.dtype == torch.bfloat16 and rate == RATE
        want = np.asarray(jax_hidden(jnp.asarray(to_np(x)), jnp.asarray(k),
                                     rate))
        np.testing.assert_array_equal(bits_of(to_np(y)), bits_of(want))
    assert abs(loss - want_loss) < 0.02
    for name, g in grads.items():
        w = want_g[name].float()
        assert (g.float() - w).norm() <= 0.03 * w.norm() + 1e-6, name


def test_gpt_remat_on_equals_off_with_dropout():
    _, on, params = models("O0", seed=3)
    off = GPTModel(GPTConfig(**SIZES, **DROP, remat=False,
                             policy=get_policy("O0")), device="cpu")
    off.load_state_dict(convert.params_from_jax(params))
    toks, tgts = batch(40)
    key = R.PRNGKey(17)
    (la, ga), (lb, gb) = (port_loss_grads(m, toks, tgts, key)
                          for m in (on, off))
    assert la == lb
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


def test_gpt_apply_and_hidden_states_take_the_key(mesh):
    jm, tm, params = models("O0", seed=4)
    toks, _ = batch(24)
    key = jax.random.PRNGKey(8)
    specs = jm.param_specs()
    f = jax.jit(jax.shard_map(lambda p, t, r: jm.apply(p, t, r), mesh=mesh,
                              in_specs=(specs, P(), P()), out_specs=P(),
                              check_vma=False))
    want = np.asarray(f(jax.tree.map(jnp.asarray, params),
                        jnp.asarray(toks), key))
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(toks), rng=np.asarray(key))
        again = tm.apply(torch.from_numpy(toks), np.asarray(key))
        plain = tm.apply(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    assert not torch.equal(got, plain)


def test_dropout_config_serves_the_same_greedy_tokens():
    """Serving passes no key, so a dropout config serves exactly what the
    same weights without dropout serve."""
    _, tm, params = models("O0", seed=12)
    plain = GPTModel(GPTConfig(**SIZES, policy=get_policy("O0")),
                     device="cpu")
    plain.load_state_dict(convert.params_from_jax(params))
    prompts = np.random.RandomState(3).randint(0, 256, (3, 12)).astype(
        np.int32)
    lengths = np.array([12, 7, 9])
    got = tm.generate(prompts, lengths, 6, page_size=4, max_seqs=2)
    want = plain.generate(prompts, lengths, 6, page_size=4, max_seqs=2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_gpt_config_takes_dropout_and_checks_its_range():
    cfg = GPTConfig(**SIZES, **DROP)
    assert cfg.hidden_dropout == cfg.attention_dropout == RATE
    for name in DROP:
        with pytest.raises(ValueError, match=name):
            GPTConfig(**SIZES, **{name: 1.0})


@pytest.mark.parametrize("shape", [(3, 37, 64), (1000,)])
def test_fp16_hidden_dropout_matches_jax_bit_for_bit(shape):
    """fp16 (O1-O3): JAX's mask bit for bit, and the kept values divided
    by ``fp16(0.9) = 0.89990234375``, the output and the gradient the
    same bits as JAX's."""
    key = jax.random.fold_in(jax.random.PRNGKey(321), 2)
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).half()
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).half()
    assert port_dropout.divisor(RATE, torch.float16) == 0.89990234375
    want, vjp = jax.vjp(lambda a: jax_hidden(a, key, RATE),
                        jnp.asarray(x.numpy()))
    (want_g,) = vjp(jnp.asarray(g.numpy()))
    xt = x.clone().requires_grad_()
    got = port_dropout.dropout(xt, np.asarray(key), RATE)
    got.backward(g)
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.detach().numpy().view(np.uint16),
                                  np.asarray(want).view(np.uint16))
    np.testing.assert_array_equal(xt.grad.numpy().view(np.uint16),
                                  np.asarray(want_g).view(np.uint16))


@pytest.mark.parametrize("rung", ["short", "mid", "pallas"])
def test_dropout_variant_fp16_band(rung):
    """The attention dropout instances in fp16 beside fmha's padding: 3
    fp16 ulps (2**-10 relative) at each output's largest magnitude."""
    q, k, v, dout = inputs(96, 96, 64, seed=14)
    qs, ks, _ = segments("fmha", 96, 96)
    want_out, want_g = jax_run(rung, q, k, v, dout, qs, ks, True, 78,
                               jnp.float16)
    got_out, got_g = port_run(rung, q, k, v, dout, qs, ks, True, 78,
                              torch.float16)
    for got, want in zip([got_out] + got_g, [want_out] + want_g):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 10)
        assert np.abs(got - want).max() <= 3 * ulp
