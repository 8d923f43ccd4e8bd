"""Entry points the port had missed against the JAX package: the "decode"
rung over contiguous K/V, the layer-norm entries without an affine and the
mixed-dtype one, and ``rope_table``'s table dtype.

The same numpy inputs go through both packages on the CPU: the JAX
functions as they run there (``fmha_decode`` through its XLA reference,
the layer norms through the Pallas body in interpret mode,
``implementation="pallas"``), the port's through the plain versions of
its kernels.

Tolerances: fp32 agrees to 1e-5 absolute and relative (fp32 sums taken
in different orders); a bf16 output to one bf16 ulp at its magnitude
(rtol 1e-2, atol 2e-2: both round the same fp32 value, which may fall on
either side of a rounding boundary); gradients of the layer norms (fp32)
to 1e-5 absolute and 1e-4 relative (the statistics' sums over a row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jax_attention
from apex_tpu.ops import attention_decode as jax_decode
from apex_tpu.ops import layer_norm as jax_ln
from apex_tpu.ops import rope as jax_rope
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_decode as port_decode
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.ops import rope as port_rope

torch.set_num_threads(1)  # the suite's parallel workers share the cores

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ decode rung
def _qkv(sk: int, seed: int):
    rng = np.random.RandomState(seed)
    q = rng.randn(1, 2, 4, 64).astype(np.float32)
    k = rng.randn(1, 2, sk, 64).astype(np.float32)
    v = rng.randn(1, 2, sk, 64).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sk", [16, 40])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("entry", ["decode_contiguous", "flash_attention"])
def test_decode_rung_matches_jax(entry, causal, sk):
    """Four query rows at the tail of 16 and 40 contiguous tokens (one
    page, and a partly filled second page of the default 128 tokens
    clipped to sk): ``decode_contiguous`` and
    ``flash_attention(implementation="decode")`` against JAX's."""
    q, k, v = _qkv(sk, seed=sk + causal)
    if entry == "decode_contiguous":
        want = jax_decode.decode_contiguous(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        got = port_decode.decode_contiguous(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal)
    else:
        want = jax_attention.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            implementation="decode")
        got = port_attention.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, implementation="decode")
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_decode_contiguous_pages_the_cache():
    """Small pages (3 pages of 16 for 40 tokens, the last one padded)
    give the same answer as one page, and the kernel's JAX name
    ``implementation="decode"`` runs it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(40, seed=7))
    one = port_decode.decode_contiguous(q, k, v, page_size=128)
    paged = port_decode.decode_contiguous(q, k, v, page_size=16,
                                          implementation="decode")
    torch.testing.assert_close(paged, one, **FP32_TOL)
    assert port_decode.FMHA_DECODE_BLOCK_H == jax_decode.FMHA_DECODE_BLOCK_H


@pytest.mark.parametrize("extra", ["bias", "segment_ids", "dropout"])
def test_decode_rung_refuses_what_it_cannot_compute(extra):
    """Bias, segment ids and dropout are refused on the decode rung, as
    in JAX; so is a causal window longer than the cache."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(16, seed=3))
    kw = {"bias": dict(bias=torch.zeros(4, 16)),
          "segment_ids": dict(q_segment_ids=torch.zeros(1, 4, dtype=torch.int32),
                              kv_segment_ids=torch.zeros(1, 16, dtype=torch.int32)),
          "dropout": dict(dropout_rate=0.1, dropout_seed=1)}[extra]
    with pytest.raises(ValueError, match="decode"):
        port_attention.flash_attention(q, k, v, implementation="decode", **kw)
    with pytest.raises(ValueError, match="sq <= sk"):
        port_decode.decode_contiguous(k, q, q, causal=True)


# ------------------------------------------------------------ layer norms
def _ln_inputs(dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(3, 5, 64) * 3.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return (jx, jnp.asarray(w), jnp.asarray(b)), (tx, torch.from_numpy(w),
                                                 torch.from_numpy(b))


def _ln_calls(entry):
    """(jax call, port call) of ``entry`` over (x, w, b)."""
    if entry == "fused_layer_norm":
        return (lambda x, w, b: jax_ln.fused_layer_norm(
                    x, (64,), implementation="pallas"),
                lambda x, w, b: port_ln.fused_layer_norm(x, (64,)))
    if entry == "fused_rms_norm":
        return (lambda x, w, b: jax_ln.fused_rms_norm(
                    x, 64, implementation="pallas"),
                lambda x, w, b: port_ln.fused_rms_norm(x, 64))
    return (lambda x, w, b: jax_ln.mixed_dtype_fused_layer_norm_affine(
                x, w, b, (64,), implementation="pallas"),
            lambda x, w, b: port_ln.mixed_dtype_fused_layer_norm_affine(
                x, w, b, (64,)))


ENTRIES = ["fused_layer_norm", "fused_rms_norm",
           "mixed_dtype_fused_layer_norm_affine"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_layer_norm_entries_match_pallas(entry, dtype):
    """The output and its dtype: ``x``'s for the entries without an
    affine, the weight's (fp32) for the mixed-dtype one."""
    jargs, targs = _ln_inputs(dtype, seed=len(entry))
    jax_call, port_call = _ln_calls(entry)
    want, got = jax_call(*jargs), port_call(*targs)
    assert got.dtype == {"bfloat16": torch.bfloat16,
                         "float32": torch.float32}[str(want.dtype)]
    tol = FP32_TOL if str(want.dtype) == "float32" and dtype == "fp32" \
        else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("entry", ENTRIES)
def test_layer_norm_entries_grads_match_pallas(entry):
    """dx (and for the mixed-dtype entry dweight, dbias) against
    ``jax.vjp`` with the same cotangent, fp32."""
    jargs, targs = _ln_inputs("fp32", seed=11)
    jax_call, port_call = _ln_calls(entry)
    dy = np.random.RandomState(12).randn(3, 5, 64).astype(np.float32)
    _, vjp = jax.vjp(jax_call, *jargs)
    want = vjp(jnp.asarray(dy))
    targs = [t.clone().requires_grad_() for t in targs]
    port_call(*targs).backward(torch.from_numpy(dy))
    n = 3 if entry.startswith("mixed") else 1
    for g, w in zip([t.grad for t in targs[:n]], want[:n]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


# ------------------------------------------------------------ rope tables
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rope_table_takes_the_dtype_third(dtype):
    """``rope_table(max_len, head_dim, dtype)`` positionally, as in JAX:
    the fp32 tables cast to the dtype."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax_rope.rope_table(256, 32, jdt)
    got = port_rope.rope_table(256, 32, tdt)
    tol = FP32_TOL if dtype == "fp32" else BF16_TOL
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)
