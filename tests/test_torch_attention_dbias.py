"""The dBias instances of the port's attention rungs (the gradient of a
trainable bias) against the JAX package's Pallas bodies.

The same numpy q/k/v, output cotangent and bias (and, where a case says
so, segment ids and a dropout seed) go through
``apex_tpu.ops.attention.flash_attention(bias=b, implementation=rung)``
with the default ``bias_requires_grad=True`` under ``jax.vjp``
(``_short_bwd_kernel``, ``_mid_bwd_kernel`` or ``_fa_bwd_dq_kernel``
emitting dbias, in interpret mode on the CPU, ``block_q=block_k=64`` on
the flash rung) and through the port's ``flash_attention`` on CPU tensors
with ``torch.autograd`` (the dBias instances' plain versions and the
wrappers' fold into the bias's shape).  The biases: ``shared`` ``(1, 1,
sq, sk)``, ``per_batch`` ``(b, 1, sq, sk)``, ``heads`` ``(1, h, sq,
sk)``, ``per_head`` ``(b, h, sq, sk)``, a 2-D ``(sq, sk)`` and ``keys``
``(b, 1, 1, sk)`` (broadcast over the queries), normal values with -1e30
on about a tenth of the entries (never a whole row).

Tolerances: fp32 products on both sides, so outputs agree to 1e-5 and
every gradient, dBias too, to 5e-5, relative and absolute, as
``tests/test_torch_attention_bias.py`` holds dq, dk and dv.  A folded
dBias is a sum over at most b*h*sq = 2*2*200 fp32 terms of magnitude
under 1 taken in another order, within the same band.  A bf16 bias gets a
bf16 gradient in both packages, each rounded once from fp32 sums that
agree within that band: the band plus one bf16 ulp (2**-7 relative) apart
at most.
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
RATE, SEED = 0.1, 0xDB1A5
#: the bias's leading dims, then whether it spans the queries
BIAS_SHAPES = {"shared": (1, 1), "per_batch": (B, 1), "heads": (1, H),
               "per_head": (B, H), "2d": (), "keys": (B, 1)}
#: the rungs' sizes: one (short) or a few (mid, flash) of their blocks
SIZES = {"short": 72, "mid": 200, "pallas": 160}


def make_bias(kind, sq, sk, seed, dtype=np.float32):
    """A float bias of ``kind``'s shape: normal values plus -1e30 on about
    a tenth of the entries, never on key 0 (so no row is all -1e30)."""
    rng = np.random.RandomState(seed)
    rows = 1 if kind == "keys" else sq
    bias = rng.randn(*BIAS_SHAPES[kind], rows, sk).astype(np.float32)
    masked = rng.rand(*bias.shape) < 0.1
    masked[..., 0] = False
    return np.where(masked, np.float32(-1e30), bias).astype(dtype)


def inputs(sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, sq, d).astype(np.float32)
    k, v = (rng.randn(B, H, sk, d).astype(np.float32) for _ in range(2))
    dout = rng.randn(B, H, sq, d).astype(np.float32)
    return q, k, v, dout


def padding_ids(sq, sk):
    """Key padding as ids: queries 0, keys past each row's length -2."""
    lens = np.array([sk, sk * 3 // 5])
    kv = np.where(np.arange(sk)[None] < lens[:, None], 0, -2)
    return np.zeros((B, sq), np.int32), kv.astype(np.int32)


def jax_run(rung, q, k, v, dout, bias, causal, ids=None, drop=False):
    """Output and ``(dq, dk, dv, dbias)`` of the JAX ``flash_attention``
    with a differentiable bias (``bias_requires_grad`` left True)."""
    kw = dict(block_q=64, block_k=64) if rung == "pallas" else {}
    if ids is not None:
        kw.update(q_segment_ids=jnp.asarray(ids[0]),
                  kv_segment_ids=jnp.asarray(ids[1]))
    if drop:
        kw.update(dropout_rate=RATE, dropout_seed=jnp.uint32(SEED))
    f = lambda q, k, v, b: jax_flash_attention(
        q, k, v, causal=causal, bias=b, implementation=rung, **kw)
    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, bias)))
    grads = vjp(jnp.asarray(dout))
    to_np = lambda x: np.asarray(x.astype(jnp.float32))
    return to_np(out), [to_np(g) for g in grads], grads[3].dtype


def port_run(rung, q, k, v, dout, bias, causal, ids=None, drop=False,
             **kw):
    """The same through the port's ``flash_attention`` and autograd; the
    bias's gradient keeps its dtype."""
    if ids is not None:
        kw.update(q_segment_ids=torch.from_numpy(ids[0]),
                  kv_segment_ids=torch.from_numpy(ids[1]))
    if drop:
        kw.update(dropout_rate=RATE, dropout_seed=SEED)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    b = torch.from_numpy(np.asarray(bias, np.float32)).to(
        torch.bfloat16 if bias.dtype == jnp.bfloat16 else torch.float32)
    b.requires_grad_()
    out = port_attention.flash_attention(q, k, v, causal=causal, bias=b,
                                         implementation=rung, **kw)
    out.backward(torch.from_numpy(dout))
    return (out.detach().numpy(),
            [t.grad.float().numpy() for t in (q, k, v, b)], b.grad.dtype)


def assert_matches(got_out, got_g, want_out, want_g):
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), got_g, want_g):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", list(BIAS_SHAPES))
@pytest.mark.parametrize("rung", list(SIZES))
def test_dbias_matches_pallas(rung, kind, causal):
    """Every rung x bias broadcast x causal: output, dq, dk, dv and the
    bias's gradient in its own shape, against the Pallas bodies'."""
    s = SIZES[rung]
    seed = s + len(kind) + causal
    q, k, v, dout = inputs(s, s, 64, seed)
    bias = make_bias(kind, s, s, seed)
    want_out, want_g, _ = jax_run(rung, q, k, v, dout, bias, causal)
    got_out, got_g, _ = port_run(rung, q, k, v, dout, bias, causal)
    assert_matches(got_out, got_g, want_out, want_g)
    assert got_g[3].shape == bias.shape and np.abs(got_g[3]).max() > 0
    if causal and kind == "per_head":
        # the tiles the causal walk skips read 0, as the Pallas bodies
        # write there
        upper = np.triu(np.ones((s, s), bool), 1)
        assert not got_g[3][..., upper].any()
        assert not want_g[3][..., upper].any()


@pytest.mark.parametrize("rung, sq, sk, causal, kind", [
    ("short", 40, 56, True, "per_batch"),     # causal sq < sk
    ("short", 56, 40, False, "heads"),
    ("mid", 150, 200, True, "shared"),        # causal sq < sk
    ("mid", 200, 150, False, "per_head"),
    ("pallas", 100, 130, True, "per_head"),   # causal sq < sk
    ("pallas", 130, 100, False, "keys"),
])
def test_dbias_ragged_lengths(rung, sq, sk, causal, kind):
    """sq != sk, each ragged against every block size, and causal with
    sq < sk: the keys past the last query are seen by no row, and the
    blocks of keys no query sees still leave zeros."""
    seed = sq + 2 * sk + causal
    q, k, v, dout = inputs(sq, sk, 64, seed)
    bias = make_bias(kind, sq, sk, seed)
    want_out, want_g, _ = jax_run(rung, q, k, v, dout, bias, causal)
    got_out, got_g, _ = port_run(rung, q, k, v, dout, bias, causal)
    assert_matches(got_out, got_g, want_out, want_g)
    if causal:
        assert not got_g[3][..., sq:].any()


@pytest.mark.parametrize("rung, d", [("short", 64), ("mid", 128),
                                     ("pallas", 64)])
def test_dbias_with_ids_and_dropout(rung, d):
    """Key padding as segment ids and dropout 0.1: a masked pair's dBias
    is 0, ``dp`` is the kept, rescaled one and ``p`` undropped, as in the
    Pallas bodies."""
    s = {"short": 80, "mid": 150, "pallas": 130}[rung]
    q, k, v, dout = inputs(s, s, d, seed=s + d)
    bias = make_bias("per_batch", s, s, seed=s + d)
    ids = padding_ids(s, s)
    want_out, want_g, _ = jax_run(rung, q, k, v, dout, bias, True, ids, True)
    got_out, got_g, _ = port_run(rung, q, k, v, dout, bias, True, ids, True)
    assert_matches(got_out, got_g, want_out, want_g)
    # the padded keys of batch row 1 get no gradient
    assert not got_g[3][1, ..., s * 3 // 5:].any()


@pytest.mark.parametrize("rung", list(SIZES))
def test_dbias_of_a_row_the_bias_masks(rung):
    """A query row the bias alone pushes to -1e30 on every key: the
    backward replays ``exp(s - lse) = 1`` there, so its dBias is ``dp -
    delta`` on every key it sees, as the Pallas bodies give; it is not
    "repaired" to 0."""
    sq = sk = 80
    q, k, v, dout = inputs(sq, sk, 64, seed=31)
    bias = make_bias("per_head", sq, sk, seed=31)
    bias[0, 1, 5] = -1e30
    bias[1, 0, 70] = -1e30
    want_out, want_g, _ = jax_run(rung, q, k, v, dout, bias, True)
    got_out, got_g, _ = port_run(rung, q, k, v, dout, bias, True)
    assert_matches(got_out, got_g, want_out, want_g)
    # dp - delta on the row's visible keys: dout . v minus dout . out
    row = got_g[3][0, 1, 5, :6]
    want = dout[0, 1, 5] @ v[0, 1, :6].T - dout[0, 1, 5] @ got_out[0, 1, 5]
    np.testing.assert_allclose(row, want, **GRAD_TOL)


@pytest.mark.parametrize("rung", list(SIZES))
def test_bf16_bias_gets_a_bf16_gradient(rung):
    """A bf16 bias (fp32 q/k/v) is read as fp32 and its gradient is
    rounded once to bf16, as JAX's ``.astype(bias.dtype)``: the two agree
    within the fp32 band plus one bf16 ulp (2**-7 of the value)."""
    s = SIZES[rung]
    q, k, v, dout = inputs(s, s, 64, seed=17)
    bias = make_bias("shared", s, s, seed=17, dtype=jnp.bfloat16)
    want_out, want_g, want_dtype = jax_run(rung, q, k, v, dout, bias, True)
    got_out, got_g, got_dtype = port_run(rung, q, k, v, dout, bias, True)
    assert want_dtype == jnp.bfloat16 and got_dtype == torch.bfloat16
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for got, want in zip(got_g[:3], want_g[:3]):
        np.testing.assert_allclose(got, want, **GRAD_TOL)
    # the fp32 sums within GRAD_TOL, each rounded to bf16 once: half an
    # ulp each, at most 2**-8 of the value
    np.testing.assert_allclose(got_g[3], want_g[3], atol=GRAD_TOL["atol"],
                               rtol=GRAD_TOL["rtol"] + 2.0 ** -7)


def test_mid_lse_cotangent_reaches_dbias():
    """``fmha_mid(return_lse=True)`` with a trainable per-batch bias and a
    cotangent on both outputs: ``dz = p * (dp - delta + dlse)`` reaches
    dBias through the delta pass, as in the JAX ``_mid_bwd_kernel``."""
    q, k, v, dout = inputs(150, 150, 64, seed=8)
    bias = make_bias("per_batch", 150, 150, seed=8)
    dlse = np.random.RandomState(9).randn(B, H, 150).astype(np.float32)

    def jf(q, k, v, b):
        return jax_fmha_mid(q, k, v, causal=True, bias=b,
                            implementation="pallas", return_lse=True)

    (want_out, want_lse), vjp = jax.vjp(jf, *map(jnp.asarray,
                                                 (q, k, v, bias)))
    want_g = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    tq, tk, tv, tb = (torch.from_numpy(x).requires_grad_()
                      for x in (q, k, v, bias))
    out, lse = port_mid.fmha_mid(tq, tk, tv, causal=True, bias=tb,
                                 return_lse=True)
    torch.autograd.backward((out, lse), (torch.from_numpy(dout),
                                         torch.from_numpy(dlse)))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               **FWD_TOL)
    for name, t, want in zip(("dq", "dk", "dv", "dbias"), (tq, tk, tv, tb),
                             want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL, err_msg=name)
    # without the lse cotangent the bias's gradient differs
    tb2 = torch.from_numpy(bias).requires_grad_()
    port_mid.fmha_mid(*map(torch.from_numpy, (q, k, v)), causal=True,
                      bias=tb2).backward(torch.from_numpy(dout))
    assert not torch.allclose(tb2.grad, tb.grad)


@pytest.fixture
def dbias_requests(monkeypatch):
    """Record the ``dbias`` each rung's backward is asked for (the short and
    mid ``_run_bwd``, the flash ``run_bwd`` of the dQ entry)."""
    seen = []

    def spy(real):
        def run(*args, dbias=False, **kw):
            seen.append(dbias)
            return real(*args, dbias=dbias, **kw)
        return run

    monkeypatch.setattr(port_short, "_run_bwd", spy(port_short._run_bwd))
    monkeypatch.setattr(port_mid, "_run_bwd", spy(port_mid._run_bwd))
    real = port_attention.flash_run_bwd
    monkeypatch.setattr(
        port_attention, "flash_run_bwd",
        lambda kernel, *a, **kw: (spy(real) if kernel == "flash_bwd_dq"
                                  else real)(kernel, *a, **kw))
    return seen


@pytest.mark.parametrize("rung", list(SIZES))
def test_only_a_bias_whose_gradient_is_asked_for_runs_dbias(rung,
                                                            dbias_requests):
    """The dBias instance runs only when autograd asks for the bias's
    gradient with ``bias_requires_grad=True``: a constant bias and
    ``bias_requires_grad=False`` keep the instance without dBias, and the
    latter's gradient is a hard zero of the bias's shape and dtype."""
    s = 24
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((1, 2, s, 64), generator=gen).requires_grad_()
    bias = torch.randn((1, 2, s, s), generator=gen)
    run = lambda b, **kw: port_attention.flash_attention(
        q, q, q, causal=True, bias=b, implementation=rung, **kw).sum()
    run(bias).backward()
    b = bias.clone().requires_grad_()
    run(b, bias_requires_grad=False).backward()
    assert torch.equal(b.grad, torch.zeros_like(b))
    assert dbias_requests == [False, False]
    run(b).backward()
    assert dbias_requests == [False, False, True]
    assert b.grad.abs().max() > 0


def test_entries_return_the_folded_bias_gradient():
    """``short_bwd``, ``mid_bwd`` and ``flash_bwd_dq`` with ``bias_grad``
    return the bias's gradient in its shape, equal to what each rung's
    autograd function gives; without a bias they raise."""
    q, k, v, dout = inputs(70, 70, 64, seed=4)
    bias = make_bias("heads", 70, 70, seed=4)
    ids = padding_ids(70, 70)
    kw = dict(q_segment_ids=torch.from_numpy(ids[0]),
              kv_segment_ids=torch.from_numpy(ids[1]), dropout_rate=RATE,
              dropout_seed=SEED)
    tq, tk, tv, tdo, tb = map(torch.from_numpy, (q, k, v, dout, bias))
    _, grads, _ = port_run("short", q, k, v, dout, bias, True, ids, True)
    for fwd, bwd in ((port_short.short_fwd, port_short.short_bwd),
                     (port_mid.mid_fwd, port_mid.mid_bwd)):
        out, lse = fwd(tq, tk, tv, causal=True, bias=tb, **kw)
        got = bwd(tq, tk, tv, out, tdo, lse, causal=True, bias=tb,
                  bias_grad=True, **kw)
        assert got[3].shape == bias.shape
        for g, want in zip(got, grads):
            np.testing.assert_allclose(g.numpy(), want, **GRAD_TOL)
        with pytest.raises(ValueError, match="needs a bias"):
            bwd(tq, tk, tv, out, tdo, lse, causal=True, bias_grad=True)
    flat = [t.reshape(B * H, 70, 64) for t in (tq, tk, tv, tdo)]
    out, lse = port_flash.flash_fwd(*flat[:3], causal=True, heads=H,
                                    bias=tb, **kw)
    delta = port_flash.flash_delta(out, flat[3])
    dq, dbias = port_flash.flash_bwd_dq(*flat, lse, delta, causal=True,
                                        heads=H, bias=tb, bias_grad=True,
                                        **kw)
    np.testing.assert_allclose(dq.reshape(B, H, 70, 64).numpy(), grads[0],
                               **GRAD_TOL)
    np.testing.assert_allclose(dbias.numpy(), grads[3], **GRAD_TOL)


def test_fold_sums_over_what_the_bias_broadcasts():
    """The fold: a dim of size 1 (or missing) where the gradient's is
    larger is summed, the rest kept; a bias expanded by a stride of 0
    (not contiguous) gets each element its own row's sum, the gradient of
    that tensor."""
    g = torch.randn((2, 3, 4, 5), generator=torch.Generator().manual_seed(0))
    fold = port_short.fold_bias_grad
    torch.testing.assert_close(fold(g, (4, 5), torch.float32), g.sum((0, 1)))
    torch.testing.assert_close(fold(g, (2, 1, 1, 5), torch.float32),
                               g.sum((1, 2), keepdim=True))
    torch.testing.assert_close(fold(g, (1, 3, 4, 5), torch.float32),
                               g.sum(0, keepdim=True))
    assert fold(g, g.shape, torch.float32).data_ptr() == g.data_ptr()
    assert fold(g, (4, 5), torch.bfloat16).dtype == torch.bfloat16
    # a (2, 1, 4, 5) bias that is one (4, 5) mask expanded by stride 0
    mask = torch.randn((4, 5), generator=torch.Generator().manual_seed(1))
    q = torch.randn((2, 3, 4, 64), generator=torch.Generator().manual_seed(2))
    k = torch.randn((2, 3, 5, 64), generator=torch.Generator().manual_seed(3))
    leaf = mask.expand(2, 1, 4, 5).requires_grad_()
    ref = mask.expand(2, 1, 4, 5).clone().requires_grad_()
    port_attention.flash_attention(q, k, k, bias=leaf).sum().backward()
    port_attention.mha_reference(q, k, k, bias=ref).sum().backward()
    torch.testing.assert_close(leaf.grad, ref.grad, **GRAD_TOL)


def test_breakdown_tool_reads_the_dq_instances_registers():
    """``tools/dbias_breakdown.py`` reads, from ``nvcc -Xptxas -v``'s
    output, the registers and spill stores of each bf16 dQ instance with
    a bias and its template flags, and skips every other kernel."""
    from apex_tpu_torch.tools.dbias_breakdown import dq_registers

    def entry(symbol, spill, regs):
        return (f"ptxas info    : Compiling entry function '{symbol}' for "
                f"'sm_90a'\nptxas info    : Function properties for "
                f"{symbol}\n    0 bytes stack frame, {spill} bytes spill "
                f"stores, 0 bytes spill loads\nptxas info    : Used {regs} "
                "registers, used 1 barriers, 656 bytes cmem[0]\n")

    dq = "_ZN4attn18attn_bwd_dq_kernelI13__nv_bfloat16Li128E"
    text = (entry(dq + "Lb0ELb0ELb1ELb0EEEvPKT_", 0, 128)
            + entry(dq + "Lb1ELb1ELb1ELb1EEEvPKT_", 8, 255)
            + entry(dq + "Lb0ELb0ELb0ELb0EEEvPKT_", 0, 120)
            + entry("_ZN4attn19attn_bwd_dkv_kernelI13__nv_bfloat16Li128E"
                    "Lb0ELb0ELb1EEEvPKT_", 0, 70)
            + entry("_ZN5flash19flash_bwd_dq_kernelIfLi64ELb0ELb0ELb1ELb1EE"
                    "EvPKT_", 0, 90))
    assert dq_registers({"attention_mid": text}) == [
        ("attention_mid", "attn_bwd_dq_kernel", 128, "BIAS", 128, 0),
        ("attention_mid", "attn_bwd_dq_kernel", 128, "SEGS+DROP+BIAS+DBIAS",
         255, 8)]


def test_breakdown_tool_reads_the_hopper_dq_instances():
    """The short/mid bf16 dQ kernel is ``attn::sm90::bwd_dq_kernel<D, NC,
    SEGS, DROP, BIAS, DBIAS>`` (``csrc/attention_bwd_sm90.cuh``): the
    tool reads its instances with a bias, and not its dK/dV kernel."""
    from apex_tpu_torch.tools.dbias_breakdown import dq_registers

    def entry(symbol, spill, regs):
        return (f"ptxas info    : Compiling entry function '{symbol}' for "
                f"'sm_90a'\nptxas info    : Function properties for "
                f"{symbol}\n    0 bytes stack frame, {spill} bytes spill "
                f"stores, 0 bytes spill loads\nptxas info    : Used {regs} "
                "registers, used 1 barriers, 656 bytes cmem[0]\n")

    sm90 = "_ZN4attn4sm9012_GLOBAL__N_1"
    text = (entry(sm90 + "13bwd_dq_kernelILi128ELi2ELb0ELb0ELb1ELb1EEEv14"
                  "CUtensorMap_stS2_S2_S2_NS1_9BwdParamsE", 0, 168)
            + entry(sm90 + "13bwd_dq_kernelILi64ELi2ELb1ELb0ELb0ELb0EEEv14"
                    "CUtensorMap_stS2_S2_S2_NS1_9BwdParamsE", 0, 168)
            + entry(sm90 + "14bwd_dkv_kernelILi128ELi2ELb0ELb0ELb1EEEv14"
                    "CUtensorMap_stS2_S2_S2_S2_S2_NS1_9BwdParamsE", 120, 168))
    assert dq_registers({"attention_short": text}) == [
        ("attention_short", "bwd_dq_kernel", 128, "BIAS+DBIAS", 168, 0)]


@pytest.mark.parametrize("rung", list(SIZES))
def test_dbias_fp16_band(rung):
    """fp16 q/k/v (O1-O3) with a trainable fp32 bias: the dBias instances
    against JAX's Pallas kernels in interpret mode.  The output and
    dq/dk/dv are held to 3 fp16 ulps (2**-10 relative) at each one's
    largest magnitude, as the other fp16 bands; the fp32 dBias, summed
    from each pair's fp32 ``dz`` in both packages, to 3 fp16 ulps of its
    largest too (``delta = rowsum(dO * O)`` reads the fp16 output)."""
    s = SIZES[rung]
    q, k, v, dout = inputs(s, s, 64, seed=23)
    bias = make_bias("per_batch", s, s, seed=23)
    kw = dict(block_q=64, block_k=64) if rung == "pallas" else {}
    f = lambda q, k, v, b: jax_flash_attention(
        q, k, v, causal=True, bias=b, implementation=rung, **kw)
    want, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.float16)
                             for x in (q, k, v)), jnp.asarray(bias))
    want_g = vjp(jnp.asarray(dout, jnp.float16))
    tq, tk, tv = (torch.from_numpy(x).half().requires_grad_()
                  for x in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_()
    got = port_attention.flash_attention(tq, tk, tv, causal=True, bias=tb,
                                         implementation=rung)
    got.backward(torch.from_numpy(dout).half())
    assert tb.grad.dtype == torch.float32 and tb.grad.shape == tb.shape
    for g, w in zip((got, tq.grad, tk.grad, tv.grad, tb.grad),
                    (want,) + tuple(want_g)):
        w = np.asarray(w.astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 10)
        assert np.abs(g.detach().float().numpy() - w).max() <= 3 * ulp
