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

**Prefix caching** rides the same allocator, as in the JAX package:
pages are refcounted, :class:`PagedKVCache` keeps a cumulative-hash index
of full prompt pages (:func:`prompt_page_hashes`, byte-identical to the
JAX hashes), admissions share matched pages read-only instead of
recomputing them (:class:`AdmitResult`), :func:`copy_pages` is the
copy-on-write for a match that ends mid-page, and eviction is pure
refcount GC.

**Moving pages** (the fleet's handoff and the host offload tier):
:func:`export_pages` gathers physical pages out of every pool buffer into
host tensors in the JAX layout, ``(num_layers, n_pages, heads, page_size,
head_dim)`` a buffer (int8 pools: int8 values plus their fp32 scales),
through ONE device-to-host copy into a pinned buffer on the card;
:func:`import_pages` scatters them into (usually another pool's) physical
pages.  No dtype ever widens, so a round trip is bit-identical, and
:func:`staged_nbytes` equals the JAX package's for the same pools.
:class:`HostOffloadPool` is the bounded LRU host tier that hangs off
``PagedKVCache.evict_hook``: pages the refcount GC would free are staged
there by prefix hash and faulted back later.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.quantization import quantize_rows
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.utils.platform import resolve_device

__all__ = [
    "KVCacheConfig",
    "CacheOutOfPages",
    "AdmitResult",
    "PageAllocator",
    "PagedKVCache",
    "HostOffloadPool",
    "prompt_page_hashes",
    "init_pools",
    "write_tokens",
    "write_targets",
    "copy_pages",
    "export_pages",
    "import_pages",
    "staged_nbytes",
]


class CacheOutOfPages(RuntimeError):
    """The pool has fewer free pages than an admission needs.  The
    serving driver treats this as backpressure (the request waits in
    the queue), not an error."""


def prompt_page_hashes(prompt_tokens, page_size: int) -> List[bytes]:
    """Cumulative SHA-1 of a prompt's FULL pages, the prefix-cache
    identity (``h_i = sha1(h_{i-1} || page_i tokens as int64)``): it
    depends only on token ids and ``page_size``, so it equals the JAX
    package's bytes for the same prompt."""
    toks = [int(t) for t in prompt_tokens]
    hashes, h = [], hashlib.sha1()
    for i in range(len(toks) // page_size):
        h.update(np.asarray(toks[i * page_size: (i + 1) * page_size],
                            np.int64).tobytes())
        hashes.append(h.digest())
    return hashes


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
    LIFO, so a hot slot's pages stay cache-warm.  Prefix caching shares
    pages READ-ONLY across holders: ``share`` adds a reference, ``free``
    drops one, and a page returns to the free list only at refcount
    zero."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refcount: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_shared(self) -> int:
        """Pages with more than one holder: live prefix sharing."""
        return sum(1 for c in self._refcount.values() if c > 1)

    def refcount(self, page: int) -> int:
        """Current holders of ``page`` (0 = free)."""
        return self._refcount.get(int(page), 0)

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

    def share(self, pages) -> None:
        """Add one reference to each of ``pages`` (all must be
        allocated).  The sharer promises READ-ONLY use: the serving
        layer's write masking keeps writes off shared pages."""
        pages = [int(p) for p in pages]
        for p in pages:
            if p not in self._refcount:
                raise ValueError(
                    f"page {p} is not allocated — cannot share")
        for p in pages:
            self._refcount[p] += 1

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


@dataclasses.dataclass
class AdmitResult:
    """What an admission reused from the prefix cache.

    ``matched_tokens`` of the prompt are already present in shared pages
    (prefill chunks wholly below this mark may be skipped);
    ``shared_pages`` of the slot's table row point at read-only pages
    other holders reference too; ``copied_page`` is the ``(src, dst)``
    physical pair the caller must copy on the device (:func:`copy_pages`)
    when the match ended mid-page: the copy-on-write tail.
    ``page_hashes`` are the prompt's full-page hashes, computed during
    the match, for :meth:`PagedKVCache.register_prefix`."""

    slot: int
    matched_tokens: int = 0
    shared_pages: int = 0
    copied_page: Optional[Tuple[int, int]] = None
    page_hashes: Optional[List[bytes]] = None


class PagedKVCache:
    """Host-side view of one serving cache: the allocator plus the
    page-table and length mirrors the driver ships to the device each
    step.  Device pools live separately (:func:`init_pools`).

    **Prefix caching**, as in the JAX package: a prefix index maps the
    cumulative hash of each FULL prompt page to the physical page that
    holds those tokens' K/V.  ``admit(prompt_tokens=...)`` longest-matches
    the prompt against it: matched pages are SHARED (refcount + 1), only
    the rest is allocated.  The last prompt token is never matched (its
    logits seed generation), so a whole-prompt match shares every page
    but the one holding that token, which is COPIED instead
    (``copied_page``).  ``register_prefix`` (after prefill has written
    the prompt) adds a slot's full prompt pages to the index, the index
    holding one reference, so registered pages outlive the slot;
    eviction is refcount GC: when an admission runs short of pages, leaf
    entries whose ONLY holder is the index are unregistered oldest-first
    and their pages freed."""

    def __init__(self, config: KVCacheConfig):
        self.config = config
        self.allocator = PageAllocator(config.num_pages)
        self.page_table = np.zeros(
            (config.max_seqs, config.pages_per_seq), np.int32)
        self.lengths = np.zeros((config.max_seqs,), np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        # cumulative page hash -> {"page", "parent" hash, "children"}
        self._prefix: Dict[bytes, Dict[str, Any]] = {}
        # slot -> pages the slot references without a table-row entry
        # (the copy-on-write SOURCE: it stays allocated for the slot's
        # lifetime, so the device copy always reads a live page)
        self._extra_refs: Dict[int, List[int]] = {}
        # the offload seam: called once per GC burst as
        # ``evict_hook([(hash, parent_hash, page), ...])`` before any of
        # those pages is freed (their device content is still valid, so
        # the hook may stage the whole burst to :class:`HostOffloadPool`
        # in one transfer); with a hook attached a burst frees at least
        # ``evict_batch`` pages.  The hook must not allocate or evict.
        self.evict_hook: Optional[Callable[
            [List[Tuple[bytes, Optional[bytes], int]]], None]] = None
        self.evict_batch: int = 8

    # ------------------------------------------------------ prefix index
    def _page_hashes(self, prompt_tokens) -> List[bytes]:
        return prompt_page_hashes(prompt_tokens, self.config.page_size)

    @property
    def prefix_index_size(self) -> int:
        return len(self._prefix)

    def match_len(self, hashes: List[bytes]) -> int:
        """Tokens of a prompt already resident in the prefix index: the
        longest run of leading ``hashes`` the index holds, in tokens (a
        read-only probe)."""
        n = 0
        for h in hashes:
            if h not in self._prefix:
                break
            n += 1
        return n * self.config.page_size

    def _evict_prefix(self, n: int, protect=()) -> int:
        """Refcount GC: unregister up to ``n`` index entries whose page
        the index alone holds (leaves first: an inner entry stays while a
        longer chain built on it survives), freeing their pages; entries
        in ``protect`` are skipped.  Returns how many pages were freed."""
        if self.evict_hook is not None:
            n = max(n, self.evict_batch)
        freed, progress = 0, True
        protect = set(protect)
        victims: List[Tuple[bytes, Optional[bytes], int]] = []
        while freed < n and progress:
            progress = False
            for h in list(self._prefix):
                if h in protect:
                    continue
                e = self._prefix[h]
                if e["children"] == 0 and \
                        self.allocator.refcount(e["page"]) == 1:
                    victims.append((h, e["parent"], e["page"]))
                    del self._prefix[h]
                    if e["parent"] is not None:
                        self._prefix[e["parent"]]["children"] -= 1
                    freed += 1
                    progress = True
                    if freed >= n:
                        break
        if victims:
            if self.evict_hook is not None:
                self.evict_hook(victims)
            self.allocator.free([p for _, _, p in victims])
        return freed

    def adopt_prefix_page(self, h: bytes, parent: Optional[bytes],
                          protect=()) -> int:
        """Allocate one page and register it under hash ``h`` with the
        index as its only holder (the fault-in half of an offload tier:
        the caller then fills the page).  Runs the refcount GC (honoring
        ``protect``) when the pool has no free page; ``parent`` must be
        indexed already, or ``None`` for a chain's head."""
        if h in self._prefix:
            raise ValueError("hash already indexed — probe before "
                             "adopting")
        if parent is not None and parent not in self._prefix:
            raise ValueError("parent hash not indexed — fault a chain "
                             "in oldest-first")
        short = 1 - self.allocator.num_free
        if short > 0:
            self._evict_prefix(short, protect=protect)
        page = self.allocator.alloc(1)[0]
        self._prefix[h] = {"page": page, "parent": parent, "children": 0}
        if parent is not None:
            self._prefix[parent]["children"] += 1
        return page

    def register_prefix(self, slot: int, prompt_tokens,
                        hashes: Optional[List[bytes]] = None) -> int:
        """Add ``slot``'s full prompt pages to the prefix index (call
        AFTER prefill has written them).  The index takes one reference
        per newly registered page; pages whose hash is indexed already
        are skipped (first writer wins).  Returns the number of pages
        newly registered.  ``hashes`` (``AdmitResult.page_hashes``) skips
        re-hashing the prompt."""
        if slot not in self._slot_pages:
            raise ValueError(f"slot {slot} is not admitted")
        pages = self._slot_pages[slot]
        if hashes is None:
            hashes = self._page_hashes(prompt_tokens)
        added, parent = 0, None
        for i, h in enumerate(hashes):
            if h not in self._prefix:
                self.allocator.share([pages[i]])
                self._prefix[h] = {"page": pages[i], "parent": parent,
                                   "children": 0}
                if parent is not None:
                    self._prefix[parent]["children"] += 1
                added += 1
            parent = h
        return added

    # ------------------------------------------------------------- admit
    def admit(self, slot: int, total_tokens: int,
              prompt_tokens=None) -> AdmitResult:
        """Reserve pages for a sequence of up to ``total_tokens`` (prompt
        + generation budget) in ``slot``.  Raises :class:`CacheOutOfPages`
        (backpressure) without allocating anything (a failed admission
        may still have evicted index-only pages: that is the GC working).

        With ``prompt_tokens`` the prompt is longest-matched against the
        prefix index and matched full pages are shared instead of
        allocated.  The caller must write nothing below
        ``matched_tokens`` and make the ``copied_page`` device copy before
        any attend touches the slot; the copy's source stays referenced
        by the slot until it retires."""
        cfg = self.config
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} is already admitted")
        if total_tokens > cfg.max_len:
            raise ValueError(
                f"sequence of {total_tokens} tokens exceeds the slot "
                f"bound {cfg.max_len} (pages_per_seq * page_size)")
        n_pages = cfg.tokens_to_pages(total_tokens)

        matched_pages: List[int] = []
        matched_tokens, cow_src, hashes = 0, None, None
        if prompt_tokens is not None:
            plen = len(prompt_tokens)
            hashes = self._page_hashes(prompt_tokens)
            for h in hashes:
                e = self._prefix.get(h)
                if e is None:
                    break
                matched_pages.append(e["page"])
            matched_tokens = len(matched_pages) * cfg.page_size
            if matched_tokens >= plen:
                # the last token's logits seed generation, so it is
                # always recomputed: its page is copied, not shared
                matched_tokens = plen - 1
                cow_src = matched_pages.pop()

        # reference the matched pages and the CoW source FIRST, so the
        # eviction below can never free a page this admission reads
        protect = matched_pages + (
            [cow_src] if cow_src is not None else [])
        self.allocator.share(protect)
        n_fresh = n_pages - len(matched_pages)
        try:
            short = n_fresh - self.allocator.num_free
            if short > 0:
                self._evict_prefix(short)
            fresh = self.allocator.alloc(n_fresh)
        except CacheOutOfPages:
            self.allocator.free(protect)
            raise
        pages = matched_pages + fresh
        copied = (cow_src, fresh[0]) if cow_src is not None else None
        if cow_src is not None:
            self._extra_refs[slot] = [cow_src]
        self._slot_pages[slot] = pages
        row = np.zeros((cfg.pages_per_seq,), np.int32)
        row[: len(pages)] = pages
        self.page_table[slot] = row
        self.lengths[slot] = 0
        return AdmitResult(
            slot=slot, matched_tokens=matched_tokens,
            shared_pages=len(matched_pages), copied_page=copied,
            page_hashes=hashes)

    def retire(self, slot: int) -> None:
        """Drop the slot's references (pages other slots or the prefix
        index still hold stay allocated) and null its table row, so a
        stale read through the old row hits the null page, never another
        request's data."""
        pages = self._slot_pages.pop(slot)
        self.allocator.free(pages)
        self.allocator.free(self._extra_refs.pop(slot, []))
        self.page_table[slot] = 0
        self.lengths[slot] = 0

    def active_slots(self) -> List[int]:
        return sorted(self._slot_pages)

    def compat_key(self) -> Tuple:
        """The cache-config family two pools must share for pages to move
        between them: everything that shapes a page's bytes (capacity,
        ``num_pages`` / ``max_seqs`` / ``pages_per_seq``, may differ).
        Dtypes by name, as the JAX package writes them."""
        cfg = self.config
        name = lambda dt: str(dt).replace("torch.", "")
        return (cfg.num_layers, cfg.num_heads, cfg.head_dim,
                cfg.page_size, name(cfg.dtype),
                None if cfg.kv_dtype is None else name(cfg.kv_dtype),
                cfg.kv_block)

    def device_tables(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(page_table, lengths)`` as int32 tensors on ``device``
        (default: the GPU): a few KB a step."""
        dev = resolve_device(device)
        return (torch.as_tensor(self.page_table, device=dev),
                torch.as_tensor(self.lengths, device=dev))


# ---------------------------------------------------------------------------
# Device side: pools + the token scatter
# ---------------------------------------------------------------------------


def init_pools(config: KVCacheConfig,
               device=None) -> Dict[str, torch.Tensor]:
    """Zeroed pools ``k``/``v`` of shape ``(num_layers, num_pages,
    num_heads / tp, page_size, head_dim)`` on ``device`` (default: the
    GPU, see :func:`apex_tpu_torch.utils.resolve_device`), plus fp32
    ``k_scales``/``v_scales`` ``(..., page_size, scale_blocks)`` filled
    with ones when quantized.  Over a tensor-parallel group of ``tp``
    ranks the pools are head-sharded: this rank's ``num_heads / tp``
    heads of every layer (a scale spans one head's ``kv_block`` dims, so
    a shard's int8 bytes are the slice of the whole pool's)."""
    cfg = config
    tp = parallel_state.get_tensor_model_parallel_world_size()
    if cfg.num_heads % tp:
        raise ValueError(
            f"tensor-parallel serving head-shards the KV pools: "
            f"num_heads={cfg.num_heads} must be divisible by tp={tp}")
    shape = (cfg.num_layers, cfg.num_pages, cfg.num_heads // tp,
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


def copy_pages(
    pools: Dict[str, torch.Tensor],
    src: torch.Tensor,
    dst: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Copy physical pages ``src -> dst`` (``(n,)`` page ids) across every
    layer and every pool buffer (K, V and, when quantized, their scales),
    in place: the copy-on-write of an admission whose prefix match ended
    mid-page.  Returns ``pools``."""
    src = torch.as_tensor(src, dtype=torch.long)
    dst = torch.as_tensor(dst, dtype=torch.long)
    for pool in pools.values():
        s, d = src.to(pool.device), dst.to(pool.device)
        pool[:, d] = pool[:, s]
    return pools


def export_pages(pools: Dict[str, torch.Tensor],
                 pages) -> Dict[str, torch.Tensor]:
    """Gather physical ``pages`` out of every pool buffer into host
    tensors: the device-to-host half of a handoff or an offload.  Each
    buffer stages as ``(num_layers, n_pages, heads, page_size, head_dim)``
    (scales: ``(..., page_size, scale_blocks)``) in its own dtype, bf16 as
    bf16 and int8 pools as int8 values plus fp32 scales, so a round trip
    through :func:`import_pages` is bit-identical.  The gathers land in
    one device buffer that crosses to the host in ONE copy (pinned on the
    card; the copy synchronises, as JAX's ``device_get`` does); the staged
    tensors are views of that host buffer."""
    dev = pools["k"].device
    idx = torch.as_tensor([int(p) for p in pages], dtype=torch.long,
                          device=dev)
    # byte spans padded to 16 so every view starts aligned for its dtype
    spans, off = {}, 0
    for k, v in pools.items():
        shape = (v.shape[0], len(idx)) + tuple(v.shape[2:])
        n = math.prod(shape) * v.element_size()
        spans[k] = (off, n, shape, v.dtype)
        off += -(-n // 16) * 16
    flat = torch.empty((off,), dtype=torch.uint8, device=dev)
    for k, (o, n, shape, dtype) in spans.items():
        # each gather writes its span of the one buffer directly
        torch.index_select(pools[k], 1, idx,
                           out=flat[o:o + n].view(dtype).view(shape))
    host = torch.empty((off,), dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    host.copy_(flat)
    return {k: host[o:o + n].view(dtype).view(shape)
            for k, (o, n, shape, dtype) in spans.items()}


def import_pages(pools: Dict[str, torch.Tensor],
                 staged: Dict[str, torch.Tensor],
                 pages) -> Dict[str, torch.Tensor]:
    """Scatter an :func:`export_pages` staging dict into physical
    ``pages`` of ``pools``, in place: the host-to-device half of a handoff
    or a fault-in.  The staged buffers must come from a pool of the same
    :meth:`PagedKVCache.compat_key` family, so the write is a bit-exact
    move; a dtype that differs raises rather than casts.  Returns
    ``pools``."""
    dev = pools["k"].device
    idx = torch.as_tensor([int(p) for p in pages], dtype=torch.long,
                          device=dev)
    for k, pool in pools.items():
        src = staged[k]
        if src.dtype != pool.dtype:
            raise ValueError(
                f"staged {k!r} is {src.dtype}, the pool {pool.dtype}: "
                "pages move between pools of one compat_key family")
        pool[:, idx] = src.to(dev, non_blocking=True)
    return pools


def staged_nbytes(staged: Dict[str, torch.Tensor]) -> int:
    """Wire bytes of a staging dict (int8 pools: the int8 payload plus the
    fp32 scales): the handoff and offload accounting."""
    return int(sum(t.numel() * t.element_size() for t in staged.values()))


class HostOffloadPool:
    """Bounded LRU host-RAM tier for evicted prefix pages.

    Hangs off :attr:`PagedKVCache.evict_hook`: when the refcount GC would
    free an index-only page, the serving layer stages its bytes here,
    keyed by the page's cumulative prefix hash, and a later admission
    whose prompt chains onto that hash faults the page back (:meth:`take`
    + :meth:`PagedKVCache.adopt_prefix_page` + :func:`import_pages`)
    bit-identically.  Entries are whole staged pages (``(layers, 1,
    heads, page_size, head_dim)`` a buffer) plus the parent hash that
    relinks the chain.  ``max_pages`` bounds host RAM; past it the least
    recently touched entry is dropped.  ``take`` pops: a faulted page
    lives on the device again and the index owns it."""

    def __init__(self, max_pages: int):
        if max_pages < 1:
            raise ValueError("max_pages must be >= 1")
        self.max_pages = int(max_pages)
        self._entries: "collections.OrderedDict[bytes, Dict[str, Any]]" \
            = collections.OrderedDict()
        self.stats = {"offloaded": 0, "faulted": 0, "lru_evicted": 0,
                      "hits": 0, "misses": 0,
                      "bytes_in": 0, "bytes_out": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, h: bytes) -> bool:
        return h in self._entries

    def put(self, h: bytes, parent: Optional[bytes],
            staged: Dict[str, torch.Tensor]) -> None:
        """Stage one page under hash ``h`` (re-staging a hash refreshes
        its LRU position and content), dropping the coldest entries past
        ``max_pages``."""
        if h in self._entries:
            self._entries.pop(h)
        self._entries[h] = {"parent": parent, "data": staged}
        self.stats["offloaded"] += 1
        self.stats["bytes_in"] += staged_nbytes(staged)
        while len(self._entries) > self.max_pages:
            self._entries.popitem(last=False)
            self.stats["lru_evicted"] += 1

    def parent(self, h: bytes) -> Optional[bytes]:
        return self._entries[h]["parent"]

    def take(self, h: bytes) -> Optional[Dict[str, Any]]:
        """Pop hash ``h``'s entry (``{"parent", "data"}``) for a fault-in,
        or ``None`` (a recorded miss) when it was never offloaded or has
        been dropped: the caller recomputes."""
        e = self._entries.pop(h, None)
        if e is None:
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        self.stats["faulted"] += 1
        self.stats["bytes_out"] += staged_nbytes(e["data"])
        return e


def write_targets(
    page_table: torch.Tensor,
    positions: torch.Tensor,
    valid: torch.Tensor,
    page_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Physical ``(pages, offsets)`` (int64) for token ``positions``.

    ``page_table`` is one slot's row ``(pages_per_seq,)`` with
    ``positions`` the prompt's ``(n,)`` token indices, or the full
    ``(slots, pages_per_seq)`` table with ``positions (slots,)`` (decode)
    or ``(slots, rows)`` (a verify step's rows at consecutive
    positions).
    Invalid entries (padding, idle slots) are redirected to the null
    page; a position past the slot's last logical page clamps to it (as
    the JAX gather does) — only finished slots decoding out a harvest
    window get there, and their writes are garbage by contract."""
    positions = positions.long()
    idx = (positions // page_size).clamp(0, page_table.shape[-1] - 1)
    table = page_table.long()
    if table.ndim == 1:
        phys = table[idx]
    elif idx.ndim == 1:
        phys = torch.gather(table, 1, idx[:, None])[:, 0]
    else:
        phys = torch.gather(table, 1, idx)
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
