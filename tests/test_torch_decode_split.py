"""The split paged decode: the plain model of its span arithmetic against
the JAX package, its bit identity by position, and its launch plan.

The CUDA decode kernels split each sequence's positions into spans of
fixed absolute positions, one block each, and merge the blocks' partial
softmax states in span order (``csrc/attention_decode.cu``).
``_decode_split_plain`` models that arithmetic in plain PyTorch; here the
same numpy query, page pools, page table and lengths go through it and
through ``apex_tpu.ops.attention_decode.fmha_decode`` with
``implementation="pallas"`` (``_decode_kernel`` in interpret mode on the
CPU), at the spans the kernels use and at a short one, with lengths at
the span edges, an idle slot (length 0), NaN on the null page and a page
table far longer than every length (most spans empty).

Tolerance: fp32 on both sides, so outputs agree to 1e-5 absolute and
relative (sums taken in different orders); int8 pages carry the same
values and scales on both sides, dequantized in fp32.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention_decode import fmha_decode as jax_fmha_decode
from apex_tpu.serving.speculate import offramp_tree, tree_ancestors
from apex_tpu_torch.ops import attention_decode as port
from apex_tpu_torch.ops.quantization import quantize_rows

H, D, KV_BLOCK = 4, 32, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _span(sq, tree=False):
    """The span the kernel takes for ``sq`` rows."""
    rows = tree or sq > port.FMHA_DECODE_MAX_SQ
    return port.DECODE_ROWS_SPAN if rows else port.DECODE_SPAN


def _edges(span):
    """An idle slot, then lengths at a span's last position, the next
    span's first two and two spans on."""
    return [0, span - 1, span, span + 1, 2 * span + 1]


def _layout(lengths, page, sq, seed, extra_pages=4):
    """Pages scattered through the pool, entries past a slot's pages on
    the null page 0, which holds NaN; ``extra_pages`` more table entries
    than the longest slot needs."""
    rng = np.random.RandomState(seed)
    lengths = np.array(lengths, np.int32)
    pps = -(-int(lengths.max()) // page) + extra_pages
    num_pages = 1 + int(sum(-(-int(n) // page) for n in lengths))
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((len(lengths), pps), np.int32)
    at = 0
    for b, n in enumerate(lengths):
        used = -(-int(n) // page)
        table[b, :used] = perm[at:at + used]
        at += used
    k = rng.randn(num_pages, H, page, D).astype(np.float32)
    v = rng.randn(num_pages, H, page, D).astype(np.float32)
    k[0] = np.nan
    v[0] = np.nan
    q = rng.randn(len(lengths), H, sq, D).astype(np.float32)
    pos = np.clip(lengths[:, None] - sq + np.arange(sq)[None], 0, None)
    ang = pos[..., None] * (10000.0 ** (-np.arange(D // 2) / (D // 2)))
    rope = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    return q, k, v, table, lengths, rope


def _int8(x):
    vals, scales = quantize_rows(
        torch.from_numpy(np.nan_to_num(x)).reshape(-1, D), KV_BLOCK)
    return (vals.reshape(x.shape).numpy(),
            scales.reshape(x.shape[:-1] + (-1,)).numpy())


def _run(q, k, v, table, lengths, rope, causal=True, int8=False,
         ancestor=None, span=None):
    """(the span model, JAX Pallas) outputs as fp32 numpy."""
    kw, jkw = {}, {}
    if int8:
        (k, ks), (v, vs) = _int8(k), _int8(v)
        kw = dict(k_scales=torch.from_numpy(ks),
                  v_scales=torch.from_numpy(vs), kv_block=KV_BLOCK)
        jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
                   kv_block=KV_BLOCK)
    tq, tk, tv, tt, tl = map(torch.from_numpy, (q, k, v, table, lengths))
    trope = None if rope is None else tuple(map(torch.from_numpy, rope))
    got = port._decode_split_plain(
        tq, tk, tv, tt, tl, causal, D ** -0.5, trope, kw.get("k_scales"),
        kw.get("v_scales"), KV_BLOCK, ancestor,
        span=span or _span(q.shape[2], ancestor is not None))
    want = jax_fmha_decode(
        *map(jnp.asarray, (q, k, v, table, lengths)), causal=causal,
        rope=None if rope is None else tuple(map(jnp.asarray, rope)),
        ancestor=ancestor, implementation="pallas", **jkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "not-causal"])
@pytest.mark.parametrize("sq", [1, 4, 64])
def test_span_model_matches_pallas(sq, causal, page):
    span = _span(sq)
    q, k, v, table, lengths, _ = _layout(_edges(span), page, sq,
                                         seed=sq + page + 3 * causal)
    got, want = _run(q, k, v, table, lengths, None, causal=causal)
    assert got.shape == q.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], 0.0)           # the idle slot
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("sq, variant", [
    (9, "tree"), (1, "int8"), (64, "int8"), (1, "rope"), (64, "rope"),
    (9, "tree-int8-rope")])
def test_span_model_variants_match_pallas(sq, variant, page):
    """The tree mask of ``offramp_tree(4)``, int8 pages and the fused
    q-RoPE, alone and together, at the span edges."""
    tree = "tree" in variant
    span = _span(sq, tree)
    q, k, v, table, lengths, rope = _layout(_edges(span), page, sq,
                                            seed=sq + page)
    anc = tree_ancestors(offramp_tree(4)) if tree else None
    got, want = _run(q, k, v, table, lengths,
                     rope if "rope" in variant else None,
                     int8="int8" in variant, ancestor=anc)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("span", [32, 64])
def test_short_spans_match_pallas(span):
    """Many spans a sequence (the same arithmetic the kernels run at
    their own spans), page 16, four rows."""
    q, k, v, table, lengths, rope = _layout(_edges(span), 16, 4, seed=span,
                                            extra_pages=12)
    got, want = _run(q, k, v, table, lengths, rope, span=span)
    np.testing.assert_allclose(got, want, **TOL)


def _chunk_rows(start, c, total, seed, others):
    """``c`` query rows of one sequence at positions ``start .. start + c``
    (write-before-attend: length ``start + c``) in slot 0, beside
    ``others`` slots of other sequences, over one pool."""
    rng = np.random.RandomState(seed)
    page = 16
    pps = -(-total // page) + 2
    b = 1 + others
    num_pages = 1 + b * pps
    k = rng.randn(num_pages, H, page, D).astype(np.float32)
    v = rng.randn(num_pages, H, page, D).astype(np.float32)
    table = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    rows = np.random.RandomState(99).randn(total, H, D).astype(np.float32)
    q = rng.randn(b, H, c, D).astype(np.float32)
    q[0] = rows[start:start + c].transpose(1, 0, 2)
    lengths = np.array([start + c] + list(
        rng.randint(c, total, others)), np.int32)
    # slot 0's pages hold the same sequence in every call
    seq_k = np.random.RandomState(98).randn(pps * page, H, D)
    seq_v = np.random.RandomState(97).randn(pps * page, H, D)
    for p in range(pps):
        k[table[0, p]] = seq_k[p * page:(p + 1) * page].transpose(1, 0, 2)
        v[table[0, p]] = seq_v[p * page:(p + 1) * page].transpose(1, 0, 2)
    return [torch.from_numpy(a) for a in (q, k, v, table, lengths)]


@pytest.mark.parametrize("span", [port.DECODE_ROWS_SPAN, 32])
def test_row_bits_depend_only_on_position(span):
    """A row's output is bit for bit the same whether its chunk starts at
    0 or mid-sequence, and whatever the other rows of the batch are: the
    spans are absolute positions and every sum runs in a fixed order (what
    keeps a prefix-cache hit's logits equal to a cold admission's)."""
    c, total = 48, 200
    outs = {}
    for start, others, seed in ((0, 0, 1), (16, 3, 2), (110, 1, 3),
                                (130, 2, 4)):
        q, k, v, table, lengths = _chunk_rows(start, c, total, seed, others)
        out = port._decode_split_plain(q, k, v, table, lengths, True,
                                       D ** -0.5, None, span=span)
        for i in range(c):
            outs.setdefault(start + i, []).append(out[0, :, i])
    shared = [p for p, got in outs.items() if len(got) > 1]
    assert len(shared) >= 40 and max(shared) > port.DECODE_ROWS_SPAN
    for p in shared:
        for other in outs[p][1:]:
            assert torch.equal(outs[p][0], other), f"position {p}"
    # the span boundaries do decide the bits: another span, other bits
    q, k, v, table, lengths = _chunk_rows(120, c, total, 3, 1)
    a, b = (port._decode_split_plain(q, k, v, table, lengths, True,
                                     D ** -0.5, None, span=s)
            for s in (32, 64))
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_split_plan_takes_shapes_only():
    """The launch plan is a function of the shapes: no lengths, no page
    table; its grid and workspace are the ones the C entries launch and
    read (``csrc/attention_decode.cu``: spans a multiple of 64 up to 512,
    row tiles of 8-64 rows, ``(b, h, sq, n_split)`` entries of d + 2
    floats, one counter per (sequence, head, row tile))."""
    params = list(inspect.signature(port._split_plan).parameters)
    assert params == ["b", "h", "sq", "d", "page_size", "pages_per_seq",
                      "rows"]
    for span in (port.DECODE_SPAN, port.DECODE_ROWS_SPAN):
        assert span % 64 == 0 and 64 <= span <= 512
    for b, h, sq, d, page, pps, rows in (
            (4, 8, 1, 128, 64, 9, False), (4, 8, 1, 128, 64, 37, False),
            (4, 8, 4, 64, 16, 3, False), (1, 8, 256, 128, 64, 8, True),
            (4, 8, 9, 128, 64, 14, True), (1, 8, 512, 128, 64, 37, True),
            (2, 4, 1, 64, 16, 1, False)):
        plan = port._split_plan(b, h, sq, d, page, pps, rows)
        span = port.DECODE_ROWS_SPAN if rows else port.DECODE_SPAN
        assert plan.span == span
        assert plan.n_split == -(-pps * page // span)
        if rows:
            assert plan.row_tile in (8, 16, 32, 64)
            assert plan.row_tile >= min(sq, port.DECODE_ROWS_TILE)
            assert plan.row_tile // 2 < sq or plan.row_tile == 8
        else:
            assert plan.row_tile == sq
        assert plan.tiles == -(-sq // plan.row_tile)
        assert plan.grid == (plan.n_split * plan.tiles, h, b)
        split = plan.n_split > 1
        assert plan.workspace == (b * h * sq * plan.n_split * (d + 2)
                                  if split else 0)
        assert plan.counters == (b * h * plan.tiles if split else 0)


def test_cuda_path_never_reads_lengths_on_the_host():
    """The CUDA path launches from shapes alone: nothing in it moves the
    lengths or the page table to the host (no sync, capturable in a CUDA
    graph)."""
    src = inspect.getsource(port._decode_cuda)
    for call in (".item()", ".cpu()", ".tolist()", ".numpy()"):
        assert call not in src
    assert "_split_plan(" in src
