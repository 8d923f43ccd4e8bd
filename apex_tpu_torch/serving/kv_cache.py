"""Paged KV cache: a page-table block allocator over a preallocated pool.

Counterpart of ``apex_tpu/serving/kv_cache.py``.  One preallocated pool
of fixed ``page_size``-token pages, a per-slot logical->physical page
table and a host-side free-list allocator: a request holds
``ceil((prompt + budget) / page_size)`` pages and returns them on
retirement; nothing is copied or compacted.

- host side (:class:`PageAllocator`, :class:`PagedKVCache`): allocation,
  free-list reuse, the page-table and length mirrors — plain Python and
  numpy, a copy of the JAX package's host code (the port imports
  nothing of it).
- device side (:func:`init_pools`, :func:`write_targets`,
  :func:`write_tokens`): the pools and the scatter that writes new
  tokens at ``(physical_page, offset)``.  The pools are updated IN PLACE
  (the JAX version returns new arrays): a serving step never copies a
  pool.

Physical page 0 is RESERVED as the null page: unallocated page-table
entries and the write targets of idle slots and padding point at it.

``kv_dtype=torch.int8`` stores the pages quantized, with one fp32 scale
per (token, ``kv_block`` dims) beside them, written through the same
:func:`~apex_tpu_torch.ops.quantization.quantize_rows` as the JAX
package's (bit-identical) and read by the paged decode kernel's int8
instance.

Not ported yet: the prefix cache with its refcounted sharing,
copy-on-write and host offload tier (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.quantization import quantize_rows
from apex_tpu_torch.utils.platform import resolve_device

__all__ = [
    "KVCacheConfig",
    "CacheOutOfPages",
    "PageAllocator",
    "PagedKVCache",
    "init_pools",
    "write_tokens",
    "write_targets",
]


class CacheOutOfPages(RuntimeError):
    """The pool has fewer free pages than an admission needs.  The
    serving driver treats this as backpressure (the request waits in
    the queue), not an error."""


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Shape and dtype of one paged cache.

    ``num_pages`` counts PHYSICAL pool pages (page 0 is the reserved null
    page, so ``num_pages - 1`` are allocatable).  ``max_seqs`` is the
    fixed slot count of the serving batch; ``pages_per_seq`` bounds one
    sequence at ``pages_per_seq * page_size`` tokens.  ``kv_dtype=None``
    stores pages in ``dtype``; ``torch.int8`` stores quantized pages with
    per-``(token, kv_block)`` fp32 scales."""

    num_layers: int
    num_heads: int
    head_dim: int
    num_pages: int
    page_size: int = 64
    max_seqs: int = 8
    pages_per_seq: int = 16
    dtype: torch.dtype = torch.bfloat16
    kv_dtype: Optional[torch.dtype] = None
    kv_block: int = 128

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError(
                "num_pages must be >= 2 (page 0 is the reserved null "
                "page)")
        if self.page_size < 1 or self.pages_per_seq < 1:
            raise ValueError("page_size and pages_per_seq must be >= 1")
        if self.kv_dtype is not None and self.kv_dtype != torch.int8:
            raise ValueError(
                f"kv_dtype must be None or int8, got {self.kv_dtype!r}")

    @property
    def quantized(self) -> bool:
        return self.kv_dtype is not None

    @property
    def scale_blocks(self) -> int:
        return -(-self.head_dim // self.kv_block)

    @property
    def max_len(self) -> int:
        return self.page_size * self.pages_per_seq

    def tokens_to_pages(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


# ---------------------------------------------------------------------------
# Host side: allocator + per-slot bookkeeping
# ---------------------------------------------------------------------------


class PageAllocator:
    """Refcounted free-list page allocator.  Page 0 is never handed out.

    ``free`` rejects pages not currently allocated (double free) and
    page 0; freed pages are reusable immediately — the free list is
    LIFO, so a hot slot's pages stay cache-warm.  A page returns to the
    free list at refcount zero (sharing, which raises a refcount above
    one, comes with the prefix cache)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refcount: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """``n`` pages at refcount 1, or :class:`CacheOutOfPages` —
        all-or-nothing, so a failed admission never leaks a partial
        allocation."""
        if n > len(self._free):
            raise CacheOutOfPages(
                f"need {n} pages, {len(self._free)} free "
                f"(pool {self.num_pages}, 1 reserved)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def free(self, pages) -> None:
        """Drop one reference per page; refcount-zero pages return to
        the free list."""
        for p in pages:
            p = int(p)
            if p == 0:
                raise ValueError("page 0 is the reserved null page")
            if p not in self._refcount:
                raise ValueError(f"page {p} is not allocated "
                                 "(double free?)")
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                del self._refcount[p]
                self._free.append(p)


class PagedKVCache:
    """Host-side view of one serving cache: the allocator plus the
    page-table and length mirrors the driver ships to the device each
    step.  Device pools live separately (:func:`init_pools`)."""

    def __init__(self, config: KVCacheConfig):
        self.config = config
        self.allocator = PageAllocator(config.num_pages)
        self.page_table = np.zeros(
            (config.max_seqs, config.pages_per_seq), np.int32)
        self.lengths = np.zeros((config.max_seqs,), np.int32)
        self._slot_pages: Dict[int, List[int]] = {}

    def admit(self, slot: int, total_tokens: int) -> List[int]:
        """Reserve pages for a sequence of up to ``total_tokens``
        (prompt + generation budget) in ``slot`` and return them.  Raises
        :class:`CacheOutOfPages` (backpressure) without allocating
        anything."""
        cfg = self.config
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} is already admitted")
        if total_tokens > cfg.max_len:
            raise ValueError(
                f"sequence of {total_tokens} tokens exceeds the slot "
                f"bound {cfg.max_len} (pages_per_seq * page_size)")
        pages = self.allocator.alloc(cfg.tokens_to_pages(total_tokens))
        self._slot_pages[slot] = pages
        row = np.zeros((cfg.pages_per_seq,), np.int32)
        row[: len(pages)] = pages
        self.page_table[slot] = row
        self.lengths[slot] = 0
        return pages

    def retire(self, slot: int) -> None:
        """Return the slot's pages and null its table row (a stale read
        through the old row hits the null page, never another request's
        data)."""
        pages = self._slot_pages.pop(slot)
        self.allocator.free(pages)
        self.page_table[slot] = 0
        self.lengths[slot] = 0


# ---------------------------------------------------------------------------
# Device side: pools + the token scatter
# ---------------------------------------------------------------------------


def init_pools(config: KVCacheConfig,
               device=None) -> Dict[str, torch.Tensor]:
    """Zeroed pools ``k``/``v`` of shape ``(num_layers, num_pages,
    num_heads, page_size, head_dim)`` on ``device`` (default: the GPU,
    see :func:`apex_tpu_torch.utils.resolve_device`), plus fp32
    ``k_scales``/``v_scales`` ``(..., page_size, scale_blocks)`` filled
    with ones when quantized."""
    cfg = config
    shape = (cfg.num_layers, cfg.num_pages, cfg.num_heads,
             cfg.page_size, cfg.head_dim)
    dev = resolve_device(device)
    dt = cfg.kv_dtype if cfg.quantized else cfg.dtype
    pools = {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
    }
    if cfg.quantized:
        sshape = shape[:-1] + (cfg.scale_blocks,)
        pools["k_scales"] = torch.ones(sshape, dtype=torch.float32,
                                       device=dev)
        pools["v_scales"] = torch.ones(sshape, dtype=torch.float32,
                                       device=dev)
    return pools


def write_targets(
    page_table: torch.Tensor,
    positions: torch.Tensor,
    valid: torch.Tensor,
    page_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Physical ``(pages, offsets)`` (int64) for token ``positions``.

    ``page_table`` is one slot's row ``(pages_per_seq,)`` with
    ``positions`` the prompt's ``(n,)`` token indices, or the full
    ``(slots, pages_per_seq)`` table with ``positions (slots,)``.
    Invalid entries (padding, idle slots) are redirected to the null
    page; a position past the slot's last logical page clamps to it (as
    the JAX gather does) — only finished slots decoding out a harvest
    window get there, and their writes are garbage by contract."""
    positions = positions.long()
    idx = (positions // page_size).clamp(0, page_table.shape[-1] - 1)
    table = page_table.long()
    if table.ndim == 1:
        phys = table[idx]
    else:
        phys = torch.gather(table, 1, idx[:, None])[:, 0]
    zero = torch.zeros_like(phys)
    return (torch.where(valid, phys, zero),
            torch.where(valid, positions % page_size, zero))


def write_tokens(
    layer_pools: Dict[str, torch.Tensor],
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pages: torch.Tensor,
    offsets: torch.Tensor,
    *,
    quantized: bool = False,
    kv_block: int = 128,
) -> Dict[str, torch.Tensor]:
    """Scatter ``n`` new tokens into ONE layer's pools, in place.

    ``layer_pools``: ``{"k", "v"[, "k_scales", "v_scales"]}`` with the
    layer axis sliced off (``(num_pages, h, page_size, d)`` views into
    the full pools).  ``k_new``/``v_new``: ``(n, h, d)`` token rows,
    quantized per ``(token, head, kv_block dims)`` when ``quantized``.
    ``pages``/``offsets``: ``(n,)`` physical targets (idle or padded
    entries point at the null page 0).  Duplicate targets (only ever the
    null page) land in an unspecified order, which a garbage page does
    not mind.  Returns ``layer_pools``."""
    # the flag must agree with the pools' own layout: truncating float
    # K/V into int8 pages while the decode kernel keeps dequantizing with
    # stale scales would be silent garbage attention
    if quantized != ("k_scales" in layer_pools):
        raise ValueError(
            f"quantized={quantized} but the pools "
            f"{'carry' if 'k_scales' in layer_pools else 'lack'} "
            "k_scales/v_scales — pass quantized=config.quantized "
            "for the config that built these pools")
    k, v = layer_pools["k"], layer_pools["v"]
    if quantized:
        n, h, d = k_new.shape
        for name, x in (("k", k_new), ("v", v_new)):
            vals, scales = quantize_rows(
                x.reshape(n * h, d).to(torch.float32), kv_block)
            layer_pools[name][pages, :, offsets] = vals.reshape(n, h, d)
            layer_pools[f"{name}_scales"][pages, :, offsets] = \
                scales.reshape(n, h, -1)
        return layer_pools
    k[pages, :, offsets] = k_new.to(k.dtype)
    v[pages, :, offsets] = v_new.to(v.dtype)
    return layer_pools
