"""Decode-tier attention (fmha-decode): a few query rows against a paged
KV cache — a CUDA kernel and its plain version.

Replaces ``apex_tpu/ops/attention_decode.py::_decode_kernel``.  Pool
layout as in the JAX package: ``(num_pages, h, page_size, d)``, page 0
the reserved null page that unallocated page-table entries (and idle
slots' writes) point at; ``lengths[b]`` counts the sequence's valid
tokens INCLUDING the query rows (write-before-attend), and query row
``i`` sits at position ``lengths[b] - sq + i``.  The kernel
(``csrc/attention_decode.cu``) notes its design: one block per
(sequence, head) walking the sequence's pages, online softmax per warp,
masked positions never read.

Ported: fp32 and bf16 pages, ``1 <= sq <= 8`` on the GPU (any ``sq`` on
the CPU), causal or not, and the fused q-RoPE (``rope=(cos, sin)``, each
``(b, sq, d/2)``): the kernel rotates q in fp32 and scales it without
rounding it to q's dtype, as the Pallas body does (the JAX XLA path
rounds the rotated q; the port follows the kernel).  Not ported yet
(ROADMAP.md queue B item 3): int8 pages with scales, the tree
``ancestor`` mask.  No single PyTorch call computes attention over this
paged layout, so the kernel has no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from apex_tpu_torch.ops.common import (
    check, check_operands, count_launch, load, stream_of,
)
from apex_tpu_torch.ops.rope import apply_rope_tables

__all__ = ["fmha_decode", "paged_attention_reference", "FMHA_DECODE_MAX_SQ"]

KERNEL = "paged_decode"

#: query rows per sequence the kernel takes (its per-warp register state)
FMHA_DECODE_MAX_SQ = 8

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def paged_attention_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain paged attention: gather each sequence's pages, masked fp32
    softmax.  K/V rows at or past ``lengths[b]`` are zeroed before use,
    so whatever garbage the null page holds (even NaN) never reaches a
    row through ``0 * NaN``: the same function the kernel computes by
    never reading them."""
    b, h, sq, d = q.shape
    num_pages = page_table.shape[1]
    page_size = k_pages.shape[2]
    scale = (1.0 / d ** 0.5) if sm_scale is None else float(sm_scale)
    table = page_table.long()
    lengths = lengths.long()

    k_pos = torch.arange(num_pages * page_size, device=q.device)
    live = (k_pos[None, :] < lengths[:, None])[:, None, :, None]

    def gather(pages):
        x = pages[table]                          # (b, np, h, ps, d)
        x = x.transpose(1, 2).reshape(b, h, num_pages * page_size, d)
        return torch.where(live, x.float(), 0.0)

    k = gather(k_pages)
    v = gather(v_pages)
    s = torch.matmul(q.float(), k.transpose(-1, -2)) * scale
    if causal:
        q_pos = (lengths[:, None] - sq
                 + torch.arange(sq, device=q.device)[None, :])
        mask = k_pos[None, None, :] <= q_pos[:, :, None]      # (b, sq, K)
    else:
        mask = (k_pos[None, :] < lengths[:, None])[:, None, :].expand(
            b, sq, -1)
    mask = mask[:, None]                                      # (b,1,sq,K)
    s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
    return torch.matmul(p, v).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry(symbol: str = KERNEL):
    """The loaded library and its C entry, typed once."""
    lib = load("attention_decode")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _decode_plain(q, k_pages, v_pages, page_table, lengths, causal, scale,
                  rope):
    """The plain version: q rotated in fp32 (not rounded) when ``rope``
    is given, then :func:`paged_attention_reference`."""
    if rope is None:
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, causal=causal,
                                         sm_scale=scale)
    cos, sin = (t.float()[:, None] for t in rope)
    qr = apply_rope_tables(q.float(), cos, sin)
    return paged_attention_reference(qr, k_pages, v_pages, page_table,
                                     lengths, causal=causal,
                                     sm_scale=scale).to(q.dtype)


def _decode_cuda(q, k_pages, v_pages, page_table, lengths, causal, scale,
                 rope):
    b, h, sq, d = q.shape
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(
            f"{KERNEL}: q and pages must share one dtype of {list(_DTYPES)}, "
            f"got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head_dim {d} not in {_HEAD_DIMS}")
    if not 1 <= sq <= FMHA_DECODE_MAX_SQ:
        raise ValueError(f"{KERNEL}: sq {sq} outside 1..{FMHA_DECODE_MAX_SQ}")
    if b > 65535:
        raise ValueError(f"{KERNEL}: batch {b} > 65535")
    q = q.contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    tables = [] if rope is None else [t.float().contiguous() for t in rope]
    check_operands(KERNEL, q, k_pages, v_pages, page_table, lengths, *tables)
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError(f"{KERNEL}: operand not 16-byte aligned")
    lib, fn = _entry()
    out = torch.empty_like(q)
    count_launch(KERNEL)
    cos, sin = (t.data_ptr() for t in tables) if tables else (None, None)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), cos, sin,
             out.data_ptr(), b, h, sq, d, k_pages.shape[2],
             page_table.shape[1],
             _DTYPES[q.dtype], int(causal), float(scale), stream_of(q))
    check(lib, KERNEL, err)
    return out


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
    rope=None,
    ancestor=None,
) -> torch.Tensor:
    """Decode attention: ``q (b, h, sq, d)`` against the paged cache
    ``k_pages``/``v_pages (num_pages, h, page_size, d)`` through
    ``page_table (b, pages_per_seq)`` (int32; unallocated entries hold
    the null page 0) with ``lengths (b,)`` valid tokens per sequence.
    ``rope=(cos, sin)``, each ``(b, sq, d/2)``, rotates q at its
    positions in the kernel (K is rotated when it is written).  A CUDA
    tensor runs the kernel, a CPU tensor the plain version."""
    if k_scales is not None or v_scales is not None \
            or k_pages.dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV pages are not ported yet (ROADMAP.md queue B item 3)")
    if ancestor is not None:
        raise NotImplementedError(
            "the tree ancestor mask is not ported yet "
            "(ROADMAP.md queue B item 3)")
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
    scale = (1.0 / d ** 0.5) if sm_scale is None else float(sm_scale)
    if q.is_cuda:
        return _decode_cuda(q, k_pages, v_pages, page_table, lengths,
                            causal, scale, rope)
    if q.device.type == "cpu":
        return _decode_plain(q, k_pages, v_pages, page_table, lengths,
                             causal, scale, rope)
    raise ValueError(f"{KERNEL}: unsupported device {q.device}")
