"""The paged decode op at many query rows and under a tree-ancestor mask,
against the JAX package.

The same numpy query, pools, page table and lengths go through
``apex_tpu.ops.attention_decode.fmha_decode`` with
``implementation="pallas"`` (``_decode_kernel`` in interpret mode on the
CPU), through its ``paged_attention_reference``, and through the port's
``fmha_decode`` on CPU tensors (the plain version of the many-row and
tree instances).  Shapes: a chunked prefill's rows (``sq`` 9, 64, 256),
a chain verify's 5, and the ancestor masks of ``chain_tree(4)`` (5 rows)
and ``offramp_tree(4)`` (9 rows); fp32, bf16 and int8 pages (``kv_block``
16); with and without the fused q-RoPE; ragged lengths and an idle slot.

Tolerances: fp32 1e-5 (sums in another order); bf16 one bf16 ulp at the
output's largest magnitude (both sides compute in fp32 and round once);
int8 pages 1e-5 (the same int8 values and scales on both sides,
dequantized in fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention_decode import fmha_decode as jax_fmha_decode
from apex_tpu.ops.attention_decode import (
    paged_attention_reference as jax_reference,
)
from apex_tpu.serving.speculate import chain_tree, offramp_tree, tree_ancestors
from apex_tpu_torch.ops import attention_decode as port
from apex_tpu_torch.ops.quantization import quantize_rows

torch.set_num_threads(1)  # the suite's parallel workers share the cores

H, D, PAGE, KV_BLOCK = 4, 32, 16, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _layout(sq, seed):
    """4 slots: idle (0), exactly the query rows, a ragged tail, a few
    pages past the rows; pages scattered through the pool, entries past a
    slot's pages on the null page 0."""
    rng = np.random.RandomState(seed)
    lengths = np.array([0, sq, sq + PAGE + 3, sq + 3 * PAGE + 7], np.int32)
    pps = -(-int(lengths.max()) // PAGE) + 1
    num_pages = 1 + int(sum(-(-n // PAGE) for n in lengths))
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((4, pps), np.int32)
    at = 0
    for b, n in enumerate(lengths):
        used = -(-int(n) // PAGE)
        table[b, :used] = perm[at:at + used]
        at += used
    k = rng.randn(num_pages, H, PAGE, D).astype(np.float32)
    v = rng.randn(num_pages, H, PAGE, D).astype(np.float32)
    q = rng.randn(4, H, sq, D).astype(np.float32)
    pos = np.clip(lengths[:, None] - sq + np.arange(sq)[None], 0, None)
    ang = pos[..., None] * (10000.0 ** (-np.arange(D // 2) / (D // 2)))
    rope = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    return q, k, v, table, lengths, rope


def _int8(x):
    vals, scales = quantize_rows(torch.from_numpy(x).reshape(-1, D), KV_BLOCK)
    return (vals.reshape(x.shape).numpy(),
            scales.reshape(x.shape[:-1] + (-1,)).numpy())


def _both(q, k, v, table, lengths, rope, pages, ancestor):
    """(port, JAX Pallas, JAX reference) outputs as fp32 numpy."""
    kw, jkw = {}, {}
    if pages == "int8":
        (k, ks), (v, vs) = _int8(k), _int8(v)
        kw = dict(k_scales=torch.from_numpy(ks),
                  v_scales=torch.from_numpy(vs), kv_block=KV_BLOCK)
        jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
                   kv_block=KV_BLOCK)
        tdt, jdt = torch.float32, jnp.float32
    elif pages == "bfloat16":
        tdt, jdt = torch.bfloat16, jnp.bfloat16
    else:
        tdt, jdt = torch.float32, jnp.float32
    qt = torch.from_numpy(q).to(tdt)
    kt, vt = (torch.from_numpy(a) for a in (k, v))
    if pages != "int8":
        kt, vt = kt.to(tdt), vt.to(tdt)
    got = port.fmha_decode(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lengths),
        rope=None if rope is None else tuple(map(torch.from_numpy, rope)),
        ancestor=ancestor, **kw)
    jq = jnp.asarray(q, jdt)
    jk, jv = (jnp.asarray(a) if pages == "int8" else jnp.asarray(a, jdt)
              for a in (k, v))
    jrope = None if rope is None else tuple(map(jnp.asarray, rope))
    pallas = jax_fmha_decode(jq, jk, jv, jnp.asarray(table),
                             jnp.asarray(lengths), rope=jrope,
                             ancestor=ancestor, implementation="pallas",
                             **jkw)
    ref = None
    if rope is None:
        ref = np.asarray(jax_reference(
            jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths),
            ancestor=ancestor, **jkw).astype(jnp.float32))
    return (got.float().numpy(), np.asarray(pallas.astype(jnp.float32)), ref)


def _close(got, want, pages):
    if pages == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp
    else:
        np.testing.assert_allclose(got, want, **TOL)


CASES = ([(sq, None) for sq in (5, 9, 64, 256)]
         + [(5, chain_tree(4)), (9, offramp_tree(4))])


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("rope", [False, True], ids=["norope", "rope"])
@pytest.mark.parametrize("sq, tree", CASES,
                         ids=[f"sq{sq}-{'causal' if t is None else len(t)}"
                              f"{'' if t is None else '-tree'}"
                              for sq, t in CASES])
def test_rows_and_ancestor_match_jax(sq, tree, rope, pages):
    q, k, v, table, lengths, tables = _layout(sq, seed=sq + 7 * rope)
    ancestor = None if tree is None else tree_ancestors(tree)
    got, pallas, ref = _both(q, k, v, table, lengths,
                             tables if rope else None, pages, ancestor)
    assert got.shape == q.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], 0.0)           # the idle slot
    _close(got, pallas, pages)
    if ref is not None:
        _close(got, ref, pages)


def test_tree_mask_differs_from_causal_and_chain_equals_causal():
    """A chain tree's mask is the causal triangle; the off-ramp tree hides
    the chain's rows from its off-ramps, so its answer differs."""
    q, k, v, table, lengths, _ = _layout(9, seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v, table, lengths)]
    causal = port.fmha_decode(*args)
    chain = port.fmha_decode(*args, ancestor=tree_ancestors(chain_tree(8)))
    tree = port.fmha_decode(*args, ancestor=tree_ancestors(offramp_tree(4)))
    torch.testing.assert_close(chain, causal, rtol=0, atol=0)
    assert (tree - causal).abs().max() > 1e-3
    # rows 0..4 of offramp_tree(4) are its chain: they see what causal does
    torch.testing.assert_close(tree[:, :, :5], causal[:, :, :5], rtol=0,
                               atol=0)


def test_nan_on_null_page_stays_out_of_the_tree_rows():
    q, k, v, table, lengths, _ = _layout(9, seed=2)
    anc = tree_ancestors(offramp_tree(4))
    clean = port.fmha_decode(*map(torch.from_numpy, (q, k, v, table,
                                                     lengths)), ancestor=anc)
    k[0] = np.nan
    v[0] = np.nan
    dirty = port.fmha_decode(*map(torch.from_numpy, (q, k, v, table,
                                                     lengths)), ancestor=anc)
    assert torch.isfinite(dirty).all()
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


@pytest.mark.parametrize("kwargs, match", [
    (dict(ancestor=((1, 0), (1, 1)), causal=False), "requires causal"),
    (dict(ancestor=((1, 0), (1, 1))), r"must be \(3, 3\)"),
    (dict(ancestor=((0, 0, 0), (1, 1, 0), (1, 1, 1))), "diagonal"),
    (dict(ancestor=((1, 1, 0), (1, 1, 0), (1, 1, 1))), "later row"),
])
def test_ancestor_validation_matches_jax(kwargs, match):
    q, k, v, table, lengths, _ = _layout(3, seed=3)
    tq = [torch.from_numpy(a) for a in (q, k, v, table, lengths)]
    jq = [jnp.asarray(a) for a in (q, k, v, table, lengths)]
    with pytest.raises(ValueError, match=match):
        port.fmha_decode(*tq, **kwargs)
    with pytest.raises(ValueError, match=match):
        jax_fmha_decode(*jq, implementation="xla", **kwargs)


def test_row_limits_match_jax():
    """More than 31 tree rows, and more than FMHA_DECODE_MAX_ROWS query
    rows, raise on every device (the JAX kernel's bounds)."""
    q, k, v, table, lengths, _ = _layout(32, seed=4)
    args = [torch.from_numpy(a) for a in (q, k, v, table, lengths)]
    full = tuple(tuple(int(j <= i) for j in range(32)) for i in range(32))
    with pytest.raises(ValueError, match="> 31"):
        port.fmha_decode(*args, ancestor=full)
    big = torch.zeros(1, H, port.FMHA_DECODE_MAX_ROWS + 1, D)
    with pytest.raises(ValueError, match="FMHA_DECODE_MAX_ROWS=512"):
        port.fmha_decode(big, *args[1:3], args[3][:1], args[4][:1])
    assert port.FMHA_DECODE_MAX_ROWS == 512
