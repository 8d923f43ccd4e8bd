"""The plain short/mid/flash backward against the JAX Pallas backward at
the raggedness of ``chip_smoke.py``'s check of the bf16 backward kernels.

``chip_smoke.py``'s ``bwd_sm90_kernels`` holds every bf16 instance of the
short, mid and flash backward kernels (``csrc/attention_bwd_sm90.cuh``) on
the card against ``_short_bwd_plain``, which ``_mid_bwd_plain`` reuses,
and ``_flash_bwd_plain``, at ragged shapes: causal with sq < sk and neither
a multiple of a tile, packed segment ids with one query row whose id no key
has (the lonely row), a bias with rows it alone hides (-1e30 on every key),
dropout and, on the mid rung, a real lse cotangent.  Here that plain version is held to the JAX package
at those combinations, scaled to CPU size: the same numpy q/k/v, output
cotangent (and lse cotangent) go through ``apex_tpu.ops.attention.
flash_attention(implementation="short")`` or ``apex_tpu.ops.attention_mid.
fmha_mid(return_lse=True)`` or ``apex_tpu.ops.attention.flash_attention(
implementation="pallas", block_q=64, block_k=64)`` with ``jax.vjp``
(``_short_bwd_kernel`` / ``_mid_bwd_kernel`` / ``_fa_bwd_dkv_kernel`` and
``_fa_bwd_dq_kernel`` in interpret mode on the CPU) and through the port's
same entries on CPU tensors with ``torch.autograd`` (the plain versions).
The files that test each variant alone (``test_torch_attention_{short,
mid,segments,bias,dbias}.py``) have no causal case with sq < sk, no lonely
row under packed ids, no bias-hidden row in a gradient check against JAX
and no dropout under the causal ragged mask; each case here adds one of
those, alone and then all together.

Tolerances: fp32 products on both sides, so outputs agree to 1e-5 and
gradients (sums of up to sk products in another order) to 5e-5, relative
and absolute, as the segments and bias files hold them.  A bias-hidden
row's gradients are those of p = exp(s - lse) = 1 on every key it sees,
in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import flash_attention as jax_flash_attention
from apex_tpu.ops.attention_mid import fmha_mid as jax_fmha_mid
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_mid as port_mid

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
B, H = 2, 2
RATE, SEED = 0.1, 0x5EED
#: the query row whose id no key has
LONELY_ROW = 3
#: query rows the bias alone hides
HIDDEN_ROWS = (5, 20)
#: (sq, sk) a rung: causal with sq < sk, neither a multiple of 64
SHAPES = {"short": (45, 70), "mid": (150, 230), "flash": (150, 230)}


def inputs(rung, d, seed):
    sq, sk = SHAPES[rung]
    rng = np.random.RandomState(seed)
    q, dout = (rng.randn(B, H, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, sk, d).astype(np.float32) for _ in range(2))
    dlse = rng.randn(B, H, sq).astype(np.float32)
    bias = rng.randn(B, H, sq, sk).astype(np.float32)
    bias[..., list(HIDDEN_ROWS), :] = np.float32(-1e30)
    # packed documents of 20 positions, and one query row no key shares
    q_ids = np.broadcast_to(np.arange(sq) // 20, (B, sq)).astype(np.int32)
    q_ids = q_ids.copy()
    q_ids[:, LONELY_ROW] = -1
    kv_ids = np.broadcast_to(np.arange(sk) // 20, (B, sk)).astype(np.int32)
    return q, k, v, dout, dlse, bias, (q_ids, kv_ids.copy())


def jax_run(rung, q, k, v, dout, dlse, ids, bias, drop):
    kw = {}
    if ids is not None:
        kw.update(q_segment_ids=jnp.asarray(ids[0]),
                  kv_segment_ids=jnp.asarray(ids[1]))
    if bias is not None:
        kw.update(bias=jnp.asarray(bias), bias_requires_grad=False)
    if drop:
        kw.update(dropout_rate=RATE, dropout_seed=jnp.uint32(SEED))
    args = [jnp.asarray(x) for x in (q, k, v)]
    if rung == "mid":
        f = lambda q, k, v: jax_fmha_mid(q, k, v, causal=True,
                                         implementation="pallas",
                                         return_lse=True, **kw)
        (out, lse), vjp = jax.vjp(f, *args)
        grads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    else:
        if rung == "flash":
            kw.update(implementation="pallas", block_q=64, block_k=64)
        else:
            kw.update(implementation="short")
        f = lambda q, k, v: jax_flash_attention(q, k, v, causal=True, **kw)
        out, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(dout))
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_run(rung, q, k, v, dout, dlse, ids, bias, drop):
    kw = {}
    if ids is not None:
        kw.update(q_segment_ids=torch.from_numpy(ids[0]),
                  kv_segment_ids=torch.from_numpy(ids[1]))
    if bias is not None:
        kw.update(bias=torch.from_numpy(bias))
    if drop:
        kw.update(dropout_rate=RATE, dropout_seed=SEED)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    if rung == "mid":
        out, lse = port_mid.fmha_mid(tq, tk, tv, causal=True,
                                     return_lse=True, **kw)
        torch.autograd.backward((out, lse), (torch.from_numpy(dout),
                                             torch.from_numpy(dlse)))
    else:
        impl = "pallas" if rung == "flash" else "short"
        out = port_attention.flash_attention(tq, tk, tv, causal=True,
                                             implementation=impl, **kw)
        out.backward(torch.from_numpy(dout))
    return (out.detach().numpy(),
            [t.grad.numpy() for t in (tq, tk, tv)])


VARIANTS = {  # (ids, bias, dropout)
    "ragged": (False, False, False),
    "lonely_row": (True, False, False),
    "hidden_rows": (False, True, False),
    "dropout": (False, False, True),
    "all": (True, True, True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("rung, d", [("short", 64), ("mid", 128),
                                     ("flash", 64)])
def test_plain_backward_matches_pallas_at_the_chip_checks_raggedness(
        rung, d, variant):
    """Causal, sq < sk, both ragged; ``variant`` adds the lonely row under
    packed ids, the bias-hidden rows, dropout, or all three; the mid rung
    takes a real lse cotangent throughout (the flash rung has none)."""
    with_ids, with_bias, drop = VARIANTS[variant]
    q, k, v, dout, dlse, bias, ids = inputs(rung, d, seed=d + len(variant))
    ids = ids if with_ids else None
    bias = bias if with_bias else None
    want_out, want_g = jax_run(rung, q, k, v, dout, dlse, ids, bias, drop)
    got_out, got_g = port_run(rung, q, k, v, dout, dlse, ids, bias, drop)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    for name, got, want in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=f"d{name}")
    if with_ids:
        # the lonely row sees no key: its output and dq are exactly 0
        assert not got_out[:, :, LONELY_ROW].any()
        assert not got_g[0][:, :, LONELY_ROW].any()


def test_build_report_reads_the_hopper_instances():
    """``chip_smoke.sm90_instances`` reads, from ``nvcc -Xptxas -v``, the
    registers and spill stores of the bf16 and fp16 forward and of both
    backward kernels, with their element type, tile sizes and template
    flags, and skips the SIMT kernels."""
    import chip_smoke

    def entry(symbol, spill, regs):
        return (f"ptxas info    : Compiling entry function '{symbol}' for "
                f"'sm_90a'\nptxas info    : Function properties for "
                f"{symbol}\n    0 bytes stack frame, {spill} bytes spill "
                f"stores, 0 bytes spill loads\nptxas info    : Used {regs} "
                "registers, used 1 barriers, 656 bytes cmem[0]\n")

    sm90 = "_ZN4attn4sm9012_GLOBAL__N_1"
    bf16, f16 = "13__nv_bfloat16", "6__half"
    text = (entry(sm90 + "10fwd_kernelI" + bf16
                  + "Li128ELi1ELb0ELb0ELb1ELb0EEEvx", 88, 128)
            + entry(sm90 + "14bwd_dkv_kernelI" + bf16
                    + "Li128ELi2ELb1ELb0ELb1EEEvx", 132, 168)
            + entry(sm90 + "13bwd_dq_kernelI" + bf16
                    + "Li64ELi2ELb0ELb1ELb1ELb1EEEvx", 0, 168)
            + entry(sm90 + "13bwd_dq_kernelI" + bf16
                    + "Li64ELi2ELb0ELb0ELb0ELb0EEEvx", 0, 168)
            + entry(sm90 + "10fwd_kernelI" + f16
                    + "Li128ELi2ELb0ELb1ELb0ELb1EEEvx", 0, 240)
            + entry(sm90 + "13bwd_dq_kernelI" + f16
                    + "Li128ELi2ELb1ELb0ELb1ELb1EEEvx", 16, 240)
            + entry("_ZN4attn12_GLOBAL__N_118attn_bwd_dq_kernelILi64ELb0E"
                    "Lb0ELb0ELb0EEEvPKf", 0, 90))
    assert chip_smoke.sm90_instances(text) == {
        "bf16 forward d=128 rows=64+bias": (128, 88),
        "bf16 dK/dV d=128 keys=128+seg+bias": (168, 132),
        "bf16 dQ d=64 rows=128+drop+bias+dbias": (168, 0),
        "bf16 dQ d=64 rows=128 plain": (168, 0),
        "fp16 forward d=128 rows=128+drop q*scale first": (240, 0),
        "fp16 dQ d=128 rows=128+seg+bias+dbias": (240, 16),
    }


def test_chip_check_of_the_bf16_backward_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.bwd_sm90_kernels`` at CPU size: on CPU tensors the
    entries run their plain versions, so every instance case must hold
    with no error, which exercises the check's plumbing (ids, the lonely
    row, the hidden rows, dropout, dlse, the dBias fold and band)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "BWD_SM90_CASES", (
        ("short", 2, 2, 50, 50, False), ("mid", 2, 2, 70, 110, True)))
    monkeypatch.setattr(chip_smoke, "BIAS_MASKED_ROWS", (5, 20))
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a))
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    chip_smoke.bwd_sm90_kernels(randn, torch.device("cpu"))
    # one summary line a dtype: bf16, then fp16
    bf16, f16 = (ln[0] for ln in lines if "instance cases held" in ln[0])
    for line in (bf16, f16):
        assert line.startswith("  48 instance cases held")
    assert "short_bwd_seg_drop_dbias 0.000" in bf16
    assert "short_bwd_seg_drop_dbias_f16 0.000" in f16


def test_chip_check_of_the_flash_bf16_backward_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.bwd_sm90_kernels`` at CPU size on one causal ragged
    flash case: the two entries ``flash_bwd_dkv`` and ``flash_bwd_dq`` on
    the flattened operands, with ``flash_delta`` and the plain forward's
    lse, hold against ``_flash_bwd_plain`` at every instance (d = 64 and
    128, 8 combinations and 4 dBias instances each), and each entry's
    counter is reported under its own name."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "BWD_SM90_CASES", (
        ("flash", 2, 2, 70, 111, True),))
    monkeypatch.setattr(chip_smoke, "BIAS_MASKED_ROWS", (5, 20))
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a))
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    chip_smoke.bwd_sm90_kernels(randn, torch.device("cpu"))
    bf16, f16 = (ln[0] for ln in lines if "instance cases held" in ln[0])
    for line, suffix in ((bf16, ""), (f16, "_f16")):
        assert line.startswith("  24 instance cases held")
        for name in ("flash_bwd_dkv_seg_drop_bias", "flash_bwd_dq_seg_drop_dbias",
                     "flash_bwd_dkv", "flash_bwd_dq_bias"):
            assert f"{name}{suffix} 0.000" in line
        assert "flash_bwd_dkv_dbias" not in line


def test_profile_counts_the_hopper_kernels_as_attention(monkeypatch):
    """``chip_smoke.attention_share`` files the bf16 forward and backward
    kernels of the ``attn::sm90`` namespace under attention, as it files
    the SIMT and flash kernels, and a cuBLAS product under matmul."""
    import chip_smoke

    rows = [(300.0, 12, "void attn::sm90::(anonymous namespace)::"
             "bwd_dkv_kernel<128, 2, false, false, false>(CUtensorMap, "
             "CUtensorMap, CUtensorMap, CUtensorMap, attn::sm90::BwdParams)"),
            (200.0, 12, "void attn::sm90::(anonymous namespace)::"
             "fwd_kernel<128, 2, false, false, false, false>(CUtensorMap)"),
            (100.0, 12, "void attn::(anonymous namespace)::attn_delta_kernel"
             "<__nv_bfloat16, 128>(__nv_bfloat16 const*)"),
            (400.0, 84, "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT")]
    monkeypatch.setattr(chip_smoke, "device_rows", lambda prof: rows)
    assert chip_smoke.attention_share(None).startswith(
        "attention 0.60 ms (60.0%), layer norm 0.00 ms (0.0%), "
        "matmul 0.40 ms (40.0%)")
