"""Decode-tier attention (fmha-decode): a few query rows against a paged
KV cache — a CUDA kernel and its plain version.

Replaces ``apex_tpu/ops/attention_decode.py::_decode_kernel``.  Pool
layout as in the JAX package: ``(num_pages, h, page_size, d)``, page 0
the reserved null page that unallocated page-table entries (and idle
slots' writes) point at; ``lengths[b]`` counts the sequence's valid
tokens INCLUDING the query rows (write-before-attend), and query row
``i`` sits at position ``lengths[b] - sq + i``.  The kernel
(``csrc/attention_decode.cu``) notes its design: each sequence's walk
split into spans of fixed absolute positions (:data:`DECODE_SPAN`,
:data:`DECODE_ROWS_SPAN`), one block per (span, head, sequence[, row
tile]), K/V streamed through shared memory, each block's unnormalised
softmax state merged in span order by the last block of its group (an
atomic ticket), masked positions never weighted.  The grid comes from
the shapes alone (:func:`_split_plan`): the host reads neither the
lengths nor the page table.

Ported: fp32, bf16 and fp16 pages (q and the pages in one dtype; the
fp16 instances are a library of their own, ``csrc/attention_decode_f16.cu``,
counted as ``<name>_f16``), and int8 pages with per-(token, kv_block)
fp32 scales ``(num_pages, h, page_size, ceil(d / kv_block))``
dequantized in fp32 before the products, ``1 <= sq <=
FMHA_DECODE_MAX_ROWS`` query rows, causal or not, the tree ``ancestor``
mask of speculative verify, and the fused q-RoPE (``rope=(cos, sin)``,
each ``(b, sq, d/2)``): the kernels rotate q in fp32 and scale it
without rounding it to q's dtype, as the Pallas body does (the JAX XLA
path rounds the rotated q; the port follows the kernel).

On the card four entries share the op, each counted under its own name:
``paged_decode`` / ``paged_decode_int8`` (up to ``FMHA_DECODE_MAX_SQ``
rows, each warp's softmax state in registers, the decode step) and the
many-row instance ``paged_decode_rows`` (up to 512 rows in tiles of at
most :data:`DECODE_ROWS_TILE`, each row adding its visible tokens in
position order: chunked prefill),
which also takes every ``ancestor`` call as ``paged_decode_tree``
(speculative verify, up to 31 rows).  No single PyTorch call computes
attention over this paged layout, so the kernels have no library
yardstick.

:func:`decode_contiguous` runs the op over contiguous ``(b, h, s_k, d)``
K/V viewed as trivially paged storage (sequence ``b``'s logical page
``p`` is physical page ``b * pages + p``): the
``flash_attention(implementation="decode")`` rung, as in JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops.common import (
    check, check_implementation, check_operands, count_launch, f16_name,
    kernel_entry, load, split_scratch, stream_of,
)
from apex_tpu_torch.ops.rope import apply_rope_tables

__all__ = ["fmha_decode", "paged_attention_reference", "decode_contiguous",
           "FMHA_DECODE_BLOCK_H", "FMHA_DECODE_MAX_SQ", "FMHA_DECODE_MAX_ROWS"]

KERNEL = "paged_decode"
KERNEL_INT8 = "paged_decode_int8"
KERNEL_ROWS = "paged_decode_rows"
KERNEL_TREE = "paged_decode_tree"

#: the heads one TPU grid program packs in the JAX kernel; ``fmha_decode``
#: takes ``block_h`` for the JAX signature and the CUDA kernels run one
#: block per (sequence, head), so it is kept only as JAX's default
FMHA_DECODE_BLOCK_H = 16

#: query rows per sequence the small kernel takes (its per-warp register
#: state); more rows, or an ancestor mask, go to the many-row instance
FMHA_DECODE_MAX_SQ = 8

#: query rows per sequence the op takes (the JAX package's bound, kept so
#: that both packages accept the same arguments)
FMHA_DECODE_MAX_ROWS = 512

#: rows of a tree verify: each row's visibility is one int32 bitmask
FMHA_DECODE_MAX_TREE_ROWS = 31

#: positions of a sequence one block of the small kernel takes: block
#: ``j`` takes ``[j * DECODE_SPAN, (j + 1) * DECODE_SPAN)``.  A constant
#: (a multiple of 64, at most 512), never derived from the batch, the
#: lengths or the card, so a row's result depends only on its positions
DECODE_SPAN = 128

#: the same for the many-row and tree instance
DECODE_ROWS_SPAN = 128

#: the most query rows a block of the many-row instance owns: a call of
#: ``sq`` rows takes tiles of the least of 8, 16, 32 and 64 rows that
#: holds them, at most this many; a narrower tile spreads its tokens over
#: more of the block's warps (``csrc/attention_decode.cu``)
DECODE_ROWS_TILE = 32

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)


def _dequant_pages(pages, scales, kv_block):
    """(..., page_size, d) int8 + (..., page_size, nb) fp32 scales ->
    fp32, per-(token, kv_block) dequantization."""
    d = pages.shape[-1]
    expand = torch.repeat_interleave(scales, kv_block, dim=-1)[..., :d]
    return pages.to(torch.float32) * expand


def paged_attention_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    kv_block: int = 128,
    ancestor: Optional[tuple] = None,
) -> torch.Tensor:
    """Plain paged attention: gather each sequence's pages (int8 pages
    dequantized with their scales), masked fp32 softmax.  K/V rows at or
    past ``lengths[b]`` are zeroed before use, so whatever garbage the
    null page holds (even NaN) never reaches a row through ``0 * NaN``:
    the same function the kernel computes by never reading them.

    ``ancestor`` (static ``(sq, sq)`` rows of 0/1) replaces the in-window
    causal triangle: query row ``i`` sees the committed prefix (positions
    below ``lengths[b] - sq``) plus fresh row ``j`` iff
    ``ancestor[i][j]``, as the JAX reference does."""
    scale = (1.0 / q.shape[-1] ** 0.5) if sm_scale is None else float(
        sm_scale)
    k, v, mask = _gather_masked(q, k_pages, v_pages, page_table, lengths,
                                causal, k_scales, v_scales, kv_block,
                                ancestor)
    s = torch.matmul(q.float(), k.transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    return torch.matmul(p, v).to(q.dtype)


def _gather_masked(q, k_pages, v_pages, page_table, lengths, causal,
                   k_scales, v_scales, kv_block, ancestor):
    """Each sequence's K and V, ``(b, h, pages_per_seq * page_size, d)``
    fp32 (int8 pages dequantized; rows at or past ``lengths[b]`` zeroed),
    and the mask ``(b, 1, sq, pages_per_seq * page_size)`` of the
    positions each query row sees."""
    b, h, sq, d = q.shape
    num_pages = page_table.shape[1]
    page_size = k_pages.shape[2]
    table = page_table.long()
    lengths = lengths.long()

    k_pos = torch.arange(num_pages * page_size, device=q.device)
    live = (k_pos[None, :] < lengths[:, None])[:, None, :, None]

    def gather(pages, scales):
        x = pages[table]                          # (b, np, h, ps, d)
        if scales is not None:
            x = _dequant_pages(x, scales[table], kv_block)
        x = x.transpose(1, 2).reshape(b, h, num_pages * page_size, d)
        return torch.where(live, x.float(), 0.0)

    if ancestor is not None:
        amat = torch.as_tensor(ancestor, dtype=torch.bool, device=q.device)
        fresh = k_pos[None, None, :] - (lengths[:, None, None] - sq)
        in_window = (fresh >= 0) & (fresh < sq)
        q_i = torch.arange(sq, device=q.device)[None, :, None]
        tree = amat[q_i, fresh.clamp(0, sq - 1)]
        mask = (fresh < 0) | (in_window & tree)               # (b, sq, K)
    elif causal:
        q_pos = (lengths[:, None] - sq
                 + torch.arange(sq, device=q.device)[None, :])
        mask = k_pos[None, None, :] <= q_pos[:, :, None]      # (b, sq, K)
    else:
        mask = (k_pos[None, :] < lengths[:, None])[:, None, :].expand(
            b, sq, -1)
    return (gather(k_pages, k_scales), gather(v_pages, v_scales),
            mask[:, None])                                    # (b,1,sq,K)


class SplitPlan(NamedTuple):
    """How a call splits over blocks, from its shapes alone: ``span``
    positions a block, ``n_split`` spans a sequence, ``row_tile`` query
    rows a block and ``tiles`` row tiles (the many-row instance; the small
    kernel takes all ``sq`` rows in one), the launch ``grid`` (x, y, z),
    the fp32 ``workspace`` elements of the blocks' partials and the int32
    ``counters`` of the merge tickets (both 0 at one span)."""

    span: int
    n_split: int
    row_tile: int
    tiles: int
    grid: tuple
    workspace: int
    counters: int


def _split_plan(b: int, h: int, sq: int, d: int, page_size: int,
                pages_per_seq: int, rows: bool) -> SplitPlan:
    """The kernels' split of a call: ``n_split = ceil(pages_per_seq *
    page_size / span)`` spans of ``span`` absolute positions (the small
    kernel :data:`DECODE_SPAN`, the many-row instance
    :data:`DECODE_ROWS_SPAN`), blocks (span, head, sequence), the
    many-row instance's span axis times its ``ceil(sq / row_tile)`` row
    tiles (``blockIdx.x = span + n_split * tile``).  Partials: ``(b, h, sq,
    n_split)`` entries of ``d + 2`` floats (acc, then m and l); one
    counter per (sequence, head[, tile]).  Takes no lengths: the launch
    is the same whatever the sequences hold."""
    return _plan(b, h, sq, d, page_size, pages_per_seq, rows,
                 DECODE_ROWS_SPAN if rows else DECODE_SPAN, DECODE_ROWS_TILE)


@functools.lru_cache(maxsize=1024)
def _plan(b, h, sq, d, page_size, pages_per_seq, rows, span,
          max_tile) -> SplitPlan:
    n_split = -(-page_size * pages_per_seq // span)
    row_tile = sq
    if rows:
        row_tile = min([t for t in (8, 16, 32, 64) if t >= sq] + [max_tile])
    tiles = -(-sq // row_tile)
    split = n_split > 1
    return SplitPlan(span, n_split, row_tile, tiles,
                     (n_split * tiles, h, b),
                     b * h * sq * n_split * (d + 2) if split else 0,
                     b * h * tiles if split else 0)


def _decode_split_plain(q, k_pages, v_pages, page_table, lengths, causal,
                        scale, rope, k_scales=None, v_scales=None,
                        kv_block=128, ancestor=None, *, span: int):
    """A plain model of the kernels' span arithmetic: q rotated in fp32
    (not rounded) and scaled first, as the kernels do, then for each span
    ``j`` of ``span`` absolute positions its partial ``m_j`` (max of the
    visible scores, -1e30 if none), ``l_j`` and ``acc_j`` (sums of
    ``exp(s - m_j)`` and of its products with V over the visible tokens,
    masked tokens selected away), merged in span order: ``M = max m_j``,
    ``sum acc_j e^(m_j - M) / max(sum l_j e^(m_j - M), 1e-30)``.  Every
    sum runs in a fixed order over elementwise operations, so a row's
    output depends only on its own inputs, bit for bit.  Used by the tests
    and ``chip_smoke.py``; nothing on the card's path runs it."""
    b, h, sq, d = q.shape
    qf = q.float()
    if rope is not None:
        cos, sin = (t.float()[:, None] for t in rope)
        qf = apply_rope_tables(qf, cos, sin)
    qf = qf * scale
    k, v, mask = _gather_masked(q, k_pages, v_pages, page_table, lengths,
                                causal, k_scales, v_scales, kv_block,
                                ancestor)
    n = -(-k.shape[2] // span)
    pad = n * span - k.shape[2]
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)).view(
        b, h, n, span, d) for x in (k, v))
    mask = torch.nn.functional.pad(mask, (0, pad)).view(b, 1, sq, n, span)
    s = torch.zeros(b, h, sq, n, span, device=q.device)
    for e in range(d):
        s = s + qf[:, :, :, e, None, None] * k[:, :, None, :, :, e]
    m = torch.where(mask, s, _NEG_INF).amax(-1)                # (b,h,sq,n)
    # exp in fp64, rounded once: the same bits for an element whatever
    # the tensor's shape
    p = torch.where(mask, torch.exp((s - m[..., None]).double()).float(),
                    0.0)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, sq, n, d, device=q.device)
    for t in range(span):
        l = l + p[..., t]
        acc = acc + torch.where(mask[..., t, None],
                                p[..., t, None] * v[:, :, None, :, t], 0.0)
    top = m.amax(-1)                                           # (b,h,sq)
    big_l = torch.zeros_like(top)
    out = torch.zeros(b, h, sq, d, device=q.device)
    for j in range(n):
        f = torch.exp((m[..., j] - top).double()).float()
        big_l = big_l + l[..., j] * f
        out = out + acc[..., j, :] * f[..., None]
    return (out / big_l.clamp_min(1e-30)[..., None]).to(q.dtype)


#: the C entries' argument types: pointers (and the stream), ints, the
#: softmax scale
_ARGTYPES = {
    KERNEL: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p],
    KERNEL_INT8: [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [
        ctypes.c_float, ctypes.c_void_p],
    KERNEL_ROWS: [ctypes.c_void_p] * 13 + [ctypes.c_int] * 15 + [
        ctypes.c_float, ctypes.c_void_p],
}

@functools.lru_cache(maxsize=None)
def _entry(symbol: str = KERNEL, source: str = "attention_decode"):
    """The loaded library and its C entry, typed once."""
    lib = load(source)
    fn = getattr(lib, symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return lib, fn


def _decode_plain(q, k_pages, v_pages, page_table, lengths, causal, scale,
                  rope, k_scales=None, v_scales=None, kv_block=128,
                  ancestor=None):
    """The plain version: q rotated in fp32 (not rounded) when ``rope``
    is given, then :func:`paged_attention_reference`."""
    qr = q
    if rope is not None:
        cos, sin = (t.float()[:, None] for t in rope)
        qr = apply_rope_tables(q.float(), cos, sin)
    return paged_attention_reference(
        qr, k_pages, v_pages, page_table, lengths, causal=causal,
        sm_scale=scale, k_scales=k_scales, v_scales=v_scales,
        kv_block=kv_block, ancestor=ancestor).to(q.dtype)


def _kernel_of(sq: int, int8: bool, ancestor) -> str:
    """The launch counter of a call (before ``_f16``): the tree, the
    many-row, the int8-page or the plain instance."""
    rows = ancestor is not None or sq > FMHA_DECODE_MAX_SQ
    return (KERNEL_TREE if ancestor is not None else KERNEL_ROWS if rows
            else KERNEL_INT8 if int8 else KERNEL)


def decode_cost(q, k_pages, page_table, lengths, k_scales, ancestor):
    """The ``(operations, bytes)`` of one decode call, as PERF.md's bound
    column counts it: q read and the output written, each visible cached
    token's K and V (and int8 scales) of every head read once, the page
    table and lengths; two products of 2 * d a (query row, token) pair.
    Counted from this call's lengths (a read of them on the host)."""
    b, h, sq, d = q.shape
    lens = [int(n) for n in lengths.tolist()]
    if ancestor is None:
        pairs = sum(max(0, min(n, n - sq + i + 1)) for n in lens
                    for i in range(sq))
    else:
        pairs = sum(max(n - sq, 0) * sq for n in lens) + len(lens) * sum(
            map(sum, ancestor))
    per_token = d * k_pages.element_size()
    if k_scales is not None:
        per_token += 4 * k_scales.shape[-1]
    nbytes = (2 * q.numel() * q.element_size() + 2 * sum(lens) * h
              * per_token + 4 * (page_table.numel() + lengths.numel()))
    return 4.0 * d * h * pairs, float(nbytes)


def _decode_cuda(q, k_pages, v_pages, page_table, lengths, causal, scale,
                 rope, k_scales=None, v_scales=None, kv_block=128,
                 ancestor=None):
    b, h, sq, d = q.shape
    int8 = k_scales is not None
    rows = ancestor is not None or sq > FMHA_DECODE_MAX_SQ
    kernel = _kernel_of(sq, int8, ancestor)
    page_dtype = torch.int8 if int8 else q.dtype
    if q.dtype not in _DTYPES or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise ValueError(
            f"{kernel}: q must be one of {list(_DTYPES)} and the pages "
            f"{page_dtype}, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {d} not in {_HEAD_DIMS}")
    if b > 65535:
        raise ValueError(f"{kernel}: batch {b} > 65535")
    q = q.contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    tables = [] if rope is None else [t.float().contiguous() for t in rope]
    scales = [] if not int8 else [k_scales, v_scales]
    check_operands(kernel, q, k_pages, v_pages, page_table, lengths,
                   *tables, *scales)
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: operand not 16-byte aligned")
    if int8 and (k_scales.dtype != torch.float32
                 or k_scales.shape != v_scales.shape
                 or tuple(k_scales.shape) != tuple(k_pages.shape[:3]) + (
                     -(-d // kv_block),)):
        raise ValueError(
            f"{kernel}: scales must be fp32 (num_pages, h, page_size, "
            f"ceil(d / kv_block)) = {tuple(k_pages.shape[:3])} + "
            f"({-(-d // kv_block)},), got {tuple(k_scales.shape)} "
            f"{k_scales.dtype}")
    lib, fn = _entry(KERNEL_ROWS if rows else kernel,
                     f16_name("attention_decode", q.dtype))
    out = torch.empty_like(q)
    cos, sin = (t.data_ptr() for t in tables) if tables else (None, None)
    pages = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    sc = ((k_scales.data_ptr(), v_scales.data_ptr()) if int8
          else (None, None))
    plan = _split_plan(b, h, sq, d, k_pages.shape[2], page_table.shape[1],
                       rows)
    stream = stream_of(q)
    ws = cnt = None
    if plan.n_split > 1:
        ws, cnt = split_scratch(q.device, stream.value, plan.workspace,
                           plan.counters)
    geometry = (b, h, sq, d, k_pages.shape[2], page_table.shape[1])
    nb = k_scales.shape[-1] if int8 else 0
    split = (plan.span, plan.n_split)
    # one launch below, of the C entry of this branch
    with count_launch(f16_name(kernel, q.dtype)):
        if rows:
            # the tree's rows as int32 bitmasks (bit j of row i: row i sees
            # fresh row j), read by the C entry from host memory and passed
            # to the kernel by value
            bits = (ctypes.c_int * FMHA_DECODE_MAX_TREE_ROWS)(*(
                [sum(int(bool(x)) << j for j, x in enumerate(r))
                 for r in ancestor] if ancestor is not None else []))
            err = fn(*pages, *sc, page_table.data_ptr(), lengths.data_ptr(),
                     cos, sin, ctypes.addressof(bits), out.data_ptr(), ws,
                     cnt, *geometry, nb, int(kv_block), _DTYPES[q.dtype],
                     int(int8), int(causal), 0 if ancestor is None else sq,
                     *split, plan.row_tile, float(scale), stream)
        elif int8:
            err = fn(*pages, *sc, page_table.data_ptr(), lengths.data_ptr(),
                     cos, sin, out.data_ptr(), ws, cnt, *geometry, nb,
                     int(kv_block), _DTYPES[q.dtype], int(causal), *split,
                     float(scale), stream)
        else:
            err = fn(*pages, page_table.data_ptr(), lengths.data_ptr(), cos,
                     sin, out.data_ptr(), ws, cnt, *geometry,
                     _DTYPES[q.dtype], int(causal), *split, float(scale),
                     stream)
    check(lib, kernel, err)
    return out


def _check_ancestor(ancestor, sq: int, causal: bool) -> tuple:
    """The JAX package's validation of a tree mask; returns it as a tuple
    of tuples of bools."""
    if not causal:
        raise ValueError(
            "ancestor mask requires causal=True — tree rows refine "
            "the causal window, they do not replace the length mask")
    ancestor = tuple(tuple(bool(x) for x in row) for row in ancestor)
    if len(ancestor) != sq or any(len(r) != sq for r in ancestor):
        raise ValueError(
            f"ancestor must be ({sq}, {sq}) to match s_q, got "
            f"({len(ancestor)}, "
            f"{len(ancestor[0]) if ancestor else 0})")
    if sq > FMHA_DECODE_MAX_TREE_ROWS:
        raise ValueError(
            f"ancestor s_q {sq} > 31 — the kernel packs each "
            "row's visibility into an int32 bitmask; speculative "
            "trees are a small handful of rows by design")
    for i, row in enumerate(ancestor):
        if not row[i]:
            raise ValueError(
                f"ancestor diagonal must be 1 (row {i} attends "
                "itself — write-before-attend)")
        if any(row[i + 1:]):
            raise ValueError(
                f"ancestor row {i} attends a later row — the tree "
                "must be topologically ordered (lower-triangular)")
    return ancestor


def fmha_decode(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    kv_block: int = 128,
    rope=None,
    block_h: Optional[int] = None,
    implementation: Optional[str] = None,
    ancestor=None,
) -> torch.Tensor:
    """Decode attention: ``q (b, h, sq, d)`` against the paged cache
    ``k_pages``/``v_pages (num_pages, h, page_size, d)`` through
    ``page_table (b, pages_per_seq)`` (int32; unallocated entries hold
    the null page 0) with ``lengths (b,)`` valid tokens per sequence.
    int8 pages take ``k_scales``/``v_scales`` ``(num_pages, h, page_size,
    ceil(d / kv_block))`` fp32.  ``rope=(cos, sin)``, each ``(b, sq,
    d/2)``, rotates q at its positions in the kernel (K is rotated when
    it is written).  ``ancestor`` (static ``(sq, sq)`` 0/1 rows,
    lower-triangular with a unit diagonal, ``sq <= 31``, causal only)
    switches the in-window causal triangle to tree visibility, as in the
    JAX package.  ``1 <= sq <= FMHA_DECODE_MAX_ROWS`` on every device.  A
    CUDA tensor runs a kernel, a CPU tensor the plain version.
    ``block_h`` (the heads a TPU grid step takes) is accepted and not
    used; ``implementation`` None, ``"pallas"`` or ``"decode"`` (the JAX
    names of the kernel) runs it."""
    check_implementation(KERNEL, implementation, ("pallas", "decode"))
    if (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pages need BOTH k_scales and v_scales")
    if k_pages.dtype == torch.int8 and k_scales is None:
        raise ValueError("int8 pages require k_scales/v_scales")
    if k_pages.dtype != torch.int8 and k_scales is not None:
        raise ValueError(
            f"scales passed with {k_pages.dtype} pages — scales belong "
            "to int8 pools only (stale scales would silently rescale "
            "full-precision K/V)")
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{KERNEL}: q {tuple(q.shape)} / pages "
                         f"{tuple(k_pages.shape)} are not (b, h, sq, d) / "
                         "(num_pages, h, page_size, d)")
    if q.shape[1] != k_pages.shape[1] or q.shape[3] != k_pages.shape[3]:
        raise ValueError(f"{KERNEL}: q heads/head_dim {q.shape[1]}/"
                         f"{q.shape[3]} != pool {k_pages.shape[1]}/"
                         f"{k_pages.shape[3]}")
    if page_table.ndim != 2 or page_table.shape[0] != q.shape[0] \
            or lengths.shape != (q.shape[0],):
        raise ValueError(
            f"{KERNEL}: page_table {tuple(page_table.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match batch {q.shape[0]}")
    b, _, sq, d = q.shape
    if rope is not None and (len(rope) != 2 or any(
            tuple(t.shape) != (b, sq, d // 2) for t in rope)):
        raise ValueError(
            f"{KERNEL}: rope tables must be (b, sq, d/2) = ({b}, {sq}, "
            f"{d // 2}), got {[tuple(t.shape) for t in rope]}")
    if not 1 <= sq <= FMHA_DECODE_MAX_ROWS:
        raise ValueError(
            f"sq = {sq} exceeds the decode kernel's per-program row budget "
            f"(FMHA_DECODE_MAX_ROWS={FMHA_DECODE_MAX_ROWS}); chunk the "
            f"query (sq <= {FMHA_DECODE_MAX_ROWS})")
    if ancestor is not None:
        ancestor = _check_ancestor(ancestor, sq, causal)
    scale = (1.0 / d ** 0.5) if sm_scale is None else float(sm_scale)
    return _run(q, k_pages, v_pages, page_table, lengths, causal, scale,
                rope, k_scales, v_scales, kv_block, ancestor)


def _costs(q, k_pages, v_pages, page_table, lengths, causal, scale, rope,
           k_scales, v_scales, kv_block, ancestor):
    """:func:`_run`'s entry costs (:func:`decode_cost`)."""
    yield (f16_name(_kernel_of(q.shape[2], k_scales is not None, ancestor),
                    q.dtype),
           decode_cost(q, k_pages, page_table, lengths, k_scales, ancestor))


@kernel_entry(_costs)
def _run(q, k_pages, v_pages, page_table, lengths, causal, scale, rope,
         k_scales, v_scales, kv_block, ancestor):
    """:func:`fmha_decode` on checked operands: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    args = (q, k_pages, v_pages, page_table, lengths, causal, scale, rope,
            k_scales, v_scales, kv_block, ancestor)
    if q.is_cuda:
        return _decode_cuda(*args)
    if q.device.type == "cpu":
        return _decode_plain(*args)
    raise ValueError(f"{KERNEL}: unsupported device {q.device}")


def decode_contiguous(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    page_size: int = 128,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """:func:`fmha_decode` over contiguous ``(b, h, s_k, d)`` K/V, viewed
    as trivially paged storage: the ``flash_attention(implementation=
    "decode")`` rung, as in JAX.  ``causal=True`` needs ``sq <= sk`` and
    places query row ``i`` at position ``sk - sq + i`` (the decode
    convention: the cache's tail is the query window; at ``sq == sk`` the
    training ladder's causal mask).  K/V are zero-padded to whole pages of
    ``min(page_size, sk)`` tokens; ``lengths`` keeps the padding out."""
    b, h, sk, d = k.shape
    sq = q.shape[2]
    if causal and sq > sk:
        raise ValueError(
            f"decode causal needs sq <= sk (query positions are the "
            f"cache tail), got sq={sq} sk={sk}")
    ps = min(int(page_size), sk)
    pad = (-sk) % ps
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    pages = (sk + pad) // ps

    def pagify(x):
        # (b, h, pages * ps, d) -> (b * pages, h, ps, d)
        return x.reshape(b, h, pages, ps, d).transpose(1, 2).reshape(
            b * pages, h, ps, d).contiguous()

    table = (torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
             * pages + torch.arange(pages, dtype=torch.int32,
                                    device=q.device)[None, :])
    lengths = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    return fmha_decode(q, pagify(k), pagify(v), table, lengths,
                       causal=causal, sm_scale=sm_scale,
                       implementation=implementation)
