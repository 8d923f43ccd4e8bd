"""The port's paged decode attention against the JAX package.

The same numpy query, page pools, page table and lengths go through
``apex_tpu.ops.attention_decode.fmha_decode`` with
``implementation="pallas"`` (``_decode_kernel`` in interpret mode on the
CPU) and through ``apex_tpu_torch.ops.attention_decode`` on CPU tensors
(the CUDA kernel's plain version).  The layout exercises what serving
produces: ragged lengths including an idle slot (length 0), partly
filled tail pages, and unallocated table entries that hold the null
page 0.

Tolerance: fp32 pages and fp32 softmax on both sides, so outputs agree
to 1e-5 absolute and relative (sums taken in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention_decode import fmha_decode as jax_fmha_decode
from apex_tpu_torch.ops import attention_decode as port_decode

TOL = dict(rtol=1e-5, atol=1e-5)
H, D, PAGE, PPS = 4, 32, 16, 9


def _layout(sq, seed):
    """4 slots: idle (0), a partial first page, an exact page boundary,
    a ragged tail several pages in.  Pages are scattered through the
    pool; entries past a slot's pages stay 0 (the null page)."""
    rng = np.random.RandomState(seed)
    lengths = np.array([0, max(sq, 5), 2 * PAGE, 4 * PAGE + 7], np.int32)
    num_pages = 1 + int(sum(-(-n // PAGE) for n in lengths))
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((4, PPS), np.int32)
    at = 0
    for b, n in enumerate(lengths):
        used = -(-int(n) // PAGE)
        table[b, :used] = perm[at:at + used]
        at += used
    k = rng.randn(num_pages, H, PAGE, D).astype(np.float32)
    v = rng.randn(num_pages, H, PAGE, D).astype(np.float32)
    q = rng.randn(4, H, sq, D).astype(np.float32)
    return q, k, v, table, lengths


def _port(q, k, v, table, lengths, causal=True):
    return port_decode.fmha_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lengths), causal=causal)


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_fp32(sq, causal):
    q, k, v, table, lengths = _layout(sq, seed=sq + 10 * causal)
    want = jax_fmha_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), causal=causal, implementation="pallas")
    got = _port(q, k, v, table, lengths, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_idle_slot_is_finite_and_nan_on_null_page_stays_out():
    """Idle slots write garbage to the null page; even NaN there must
    neither make the idle slot's row NaN nor reach a live row."""
    q, k, v, table, lengths = _layout(1, seed=3)
    clean = _port(q, k, v, table, lengths).numpy()
    k[0] = np.nan
    v[0] = np.nan
    dirty = _port(q, k, v, table, lengths).numpy()
    assert np.isfinite(dirty).all()
    np.testing.assert_array_equal(dirty[0], 0.0)        # length 0
    np.testing.assert_array_equal(dirty, clean)


def test_unported_options_raise():
    q, k, v, table, lengths = _layout(1, seed=4)
    args = [torch.from_numpy(a) for a in (q, k, v, table, lengths)]
    with pytest.raises(NotImplementedError, match="queue B"):
        port_decode.fmha_decode(*args, ancestor=((True,),))
    # int8 pages are ported: without their scales they raise JAX's error
    with pytest.raises(ValueError, match="require k_scales"):
        port_decode.fmha_decode(*args[:1], args[1].to(torch.int8),
                                args[2].to(torch.int8), *args[3:])


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_q_rope_matches_pallas(sq, dtype):
    """``rope=(cos, sin)``, each ``(b, sq, d/2)``: q rotated in fp32 at
    its positions and not rounded to q's dtype, as the Pallas body does
    (fp32 pages: 1e-5; bf16 pages: the same unrounded rotation on both
    sides, so the outputs differ by their final rounding, one bf16 ulp
    at the output's magnitude)."""
    q, k, v, table, lengths = _layout(sq, seed=20 + sq)
    pos = lengths[:, None] - sq + np.arange(sq)[None]
    ang = np.clip(pos, 0, None)[..., None] * (
        10000.0 ** (-np.arange(D // 2) / (D // 2)))[None, None]
    cos, sin = (f(ang).astype(np.float32) for f in (np.cos, np.sin))
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax_fmha_decode(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(table),
        jnp.asarray(lengths), rope=(jnp.asarray(cos), jnp.asarray(sin)),
        implementation="pallas")
    got = port_decode.fmha_decode(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(table), torch.from_numpy(lengths),
        rope=(torch.from_numpy(cos), torch.from_numpy(sin)))
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got.float().numpy() - want).max() <= ulp
    # the rotation does change the answer
    plain = _port(q, k, v, table, lengths).numpy()
    assert np.abs(plain[1:] - want[1:]).max() > 1e-3


def test_rope_tables_must_be_b_sq_half_d():
    q, k, v, table, lengths = _layout(1, seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v, table, lengths)]
    bad = torch.zeros(4, 1, D)
    with pytest.raises(ValueError, match="rope tables"):
        port_decode.fmha_decode(*args, rope=(bad, bad))
