"""Continuous batching: admit/retire requests into fixed-shape slots.

Counterpart of ``apex_tpu/serving/serve.py``.  The driver's steps keep
static shapes (``max_seqs`` slots, a ``max_prompt_len`` prompt window or
``prefill_chunk`` tokens a chunk, one paged cache) and request churn only
changes contents (page-table rows, length counters, budgets, chunk
offsets).

Two prompt-ingestion modes, as in the JAX package:

- **monolithic** (``prefill_chunk=None``): an admission runs ONE prefill
  over the whole padded prompt; every decoding slot waits for it.
- **chunked** (``prefill_chunk=C`` and the model's chunk step): prompts
  are ingested in fixed C-token chunks through the paged kernel's
  many-row instance, and each serving step runs at most ONE chunk (oldest
  admission first) beside one decode token for every live slot
  (Sarathi-style), so decoding slots stall for a chunk, not a prompt.
  Chunk boundaries are absolute (chunk k covers ``[k*C, (k+1)*C)``),
  which makes a prefix-cache hit bit-identical to a cold admission.

**Prefix caching** (``prefix_cache=True``, chunked only): admissions
share the full prompt pages the cache's prefix index already holds,
skip the chunks wholly inside the match, and copy the page of a match
that ends mid-page (copy-on-write, before any attend touches the slot);
a slot registers its prompt pages once its last chunk has run.

**Speculative decoding** (``spec_fn`` + ``speculate_k``): each serving
step drafts up to k tokens a live slot on the host (``draft_source``,
n-gram self-speculation by default), verifies and commits on the device,
and resolves the commits at once (one small sync a verify step, because
the next draft needs them); budgets are counted exactly on the host.

Loop anatomy (:meth:`ContinuousBatcher.run`):

1. **admit** — while a slot is free, a request is queued and the page
   allocator has room (``CacheOutOfPages`` is backpressure): reserve
   pages for prompt + budget (sharing prefix-matched pages), then either
   run the monolithic prefill (the slot joins decode at once with its
   first token still on device) or queue the slot for chunked ingestion.
2. **window** — up to ``harvest_every`` serving steps: at most one
   prefill chunk and one decode step for all live slots each (a slot
   whose last chunk ran joins the decode of that same step).
   Per-slot state (current token, length, budget, done flag) lives on
   the device and each step updates it there: sampled ids feed the next
   embedding lookup directly, finished slots freeze (their writes go to
   the null page), nothing touches the host.
3. **harvest** — ONE device-to-host copy per window for the window's
   tokens, the pending first tokens and the done flags together.  The
   host then truncates each stream at EOS/budget, retires finished
   slots and goes back to 1.

A slot that finishes mid-window decodes garbage until the window closes
(its writes stay inside its own pages or on the null page), in exchange
for a decode loop with no per-token host sync.  TTFT is quantized to the
harvest cadence.  ``measure_stall=True`` synchronises around each prefill
dispatch to measure the decode stall it caused (``decode_stall_s``,
``max_prefill_stall_s``).

Sampling keys are per slot: the carry holds a ``sample_keys`` row a
slot, written at admission (``PRNGKey(Request.seed)`` for a seeded
request, else ``fold_in(server key, admissions so far)``), and every draw
folds the slot's context length into it, so a seeded request samples the
same stream in any slot at any admission order.

On the card the decode and verify steps of ``decode_fns`` replay one CUDA
graph per (pools, step shape) (``serving/graphs.py``): a step's outputs
are the graph's static buffers, so the window keeps a copy of each step's
tokens, and the carry a replay returns is this batcher's own static carry,
which the in-place writes below (admission, retirement, ``cancel``, an
import) update.

**The fleet's seams** (``apex_tpu_torch/fleet``): ``live_slots``,
:meth:`ContinuousBatcher.pump` (one admit + one harvest window over an
external queue), :meth:`~ContinuousBatcher.cancel`, the levers
``decode_enabled`` (off on a prefill-role replica), ``speculation_enabled``
and ``chunk_throttle`` (the brownout ladder's; scheduling only, a stream's
tokens never change), and the disaggregation handoff:
:meth:`~ContinuousBatcher.handoff_ready`,
:meth:`~ContinuousBatcher.export_request` (a :class:`HandoffPacket` of the
request's committed tokens and its KV pages staged on the host) and
:meth:`~ContinuousBatcher.import_request` (the pages scattered and the
carry row written in one step, ``_import_state``).  ``offload=`` (a
:class:`~apex_tpu_torch.serving.kv_cache.HostOffloadPool`, with
``prefix_cache``) stages pages the prefix GC evicts to host RAM in one
transfer a burst and faults them back at admission, bit-identical.
Every harvest resolves through the module's ``_device_get``, the seam a
fault injector hangs (``resilience.faults.hanging_harvests``).

``logger=`` (a :class:`~apex_tpu_torch.telemetry.metrics.MetricsLogger`,
or anything with ``event`` and ``gauge``) receives the JAX batcher's
records: ``request_admitted``, ``prefix_hit``, ``span`` (``prefill``,
``prefill_chunk``, ``decode`` with the weight stream's fields),
``spec_accept``, ``request_done``, ``page_offload``, ``page_faultin``,
``request_exported``, ``request_imported``, ``request_cancelled``, and
after every admission pass the ``pages_free``, ``pages_shared``,
``live_slots`` and ``queue_depth`` gauges.  All are host values: the
logger adds no synchronisation.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.random import PRNGKey, fold_in, keys_tensor
from apex_tpu_torch.serving.kv_cache import (
    CacheOutOfPages,
    HostOffloadPool,
    PagedKVCache,
    copy_pages,
    export_pages,
    import_pages,
    prompt_page_hashes,
    staged_nbytes,
)
from apex_tpu_torch.serving.speculate import NGramDraftSource, tree_chain_rows
from apex_tpu_torch.telemetry.spans import phase
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["Request", "Completion", "HandoffPacket", "ContinuousBatcher",
           "init_carry"]


def _to_host(x):
    """A device tensor, or a list of them, on the host (a synchronising
    copy)."""
    if isinstance(x, (list, tuple)):
        return [t.cpu() for t in x]
    return x.cpu()


#: the harvest-resolve seam: both windows pull device results through this
#: module attribute, so a fault injector can hang a harvest where a wedged
#: device would (``resilience.faults.hanging_harvests``)
_device_get = _to_host


@dataclasses.dataclass
class Request:
    """One generation request.  ``prompt`` is token ids; generation stops
    after ``max_new_tokens`` or at the server's ``eos_id``.  ``seed`` pins
    a sampled request's stream: its draws use ``PRNGKey(seed)`` folded
    with each position, whatever its slot or admission order."""

    uid: Any
    prompt: Sequence[int]
    max_new_tokens: int
    seed: Optional[int] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(self.prompt) < 1:
            raise ValueError("prompt must be non-empty")


@dataclasses.dataclass
class Completion:
    """``tokens`` are the generated ids (EOS included when hit)."""

    uid: Any
    tokens: List[int]
    prompt_len: int
    reason: str                 # "eos" | "budget"
    ttft_s: Optional[float] = None
    duration_s: Optional[float] = None


@dataclasses.dataclass
class HandoffPacket:
    """One request's decode state in flight between replicas: the
    committed tokens plus the host-staged bytes of every KV page written
    so far (:func:`~apex_tpu_torch.serving.kv_cache.export_pages` layout;
    int8 pools stage int8 values and fp32 scales).  Built by
    :meth:`ContinuousBatcher.export_request`, consumed by
    :meth:`ContinuousBatcher.import_request`; the sampling keys fold the
    absolute context length, so the continued stream is the one that
    never moved (greedy, or a seeded request)."""

    req: Request
    #: tokens committed on the source before the export
    tokens: List[int]
    staged: Dict[str, torch.Tensor]
    n_pages: int
    #: KV positions written on the source: ``prompt + len(tokens) - 1``
    #: (the newest token's K/V is written by the next decode step)
    written: int
    wire_bytes: int
    #: the source cache's page-layout family
    #: (:meth:`~apex_tpu_torch.serving.kv_cache.PagedKVCache.compat_key`)
    compat_key: tuple
    #: the prompt's cumulative page hashes, so the destination's prefix
    #: index adopts the imported pages without re-hashing
    hashes: Optional[List[bytes]] = None


def _import_state(pools, carry, staged, pages, slot: int, last: int,
                 written: int, steps_left: int, done: bool,
                 skey) -> None:
    """The import side of a handoff as one step: the staged pages
    scattered into ``pages`` and every carry field of ``slot`` written, in
    place (``carry`` is the importing batcher's, on the card its graph's
    static carry)."""
    import_pages(pools, staged, pages)
    dev = carry["tokens"].device
    carry["tokens"][slot] = int(last)
    carry["lengths"][slot] = int(written)
    carry["steps_left"][slot] = int(steps_left)
    carry["done"][slot] = bool(done)
    carry["sample_keys"][slot] = keys_tensor(skey, dev)[0]


def init_carry(max_seqs: int, key=None,
               device=None) -> Dict[str, torch.Tensor]:
    """The decode step's per-slot device state: all slots idle.
    ``sample_keys`` holds one PRNG key a slot, ``(max_seqs, 2)`` int64
    words, every row ``key`` (default ``PRNGKey(0)``) until admission
    overwrites it."""
    dev = resolve_device(device)
    s = max_seqs
    base = keys_tensor(PRNGKey(0) if key is None else key, dev)
    return {
        "tokens": torch.zeros((s,), dtype=torch.int32, device=dev),
        "lengths": torch.zeros((s,), dtype=torch.int32, device=dev),
        "steps_left": torch.zeros((s,), dtype=torch.int32, device=dev),
        "done": torch.ones((s,), dtype=torch.bool, device=dev),
        "sample_keys": base.expand(s, 2).contiguous(),
    }


class ContinuousBatcher:
    """Drive the serving step functions over a paged cache.

    ``prefill_fn(pools, tokens (1, max_prompt_len) int32, length: int,
    page_row (pages_per_seq,) int32, key) -> (pools, first_token)`` writes
    the prompt's K/V and samples the first token (a 0-d device tensor)
    under the slot's key (a host key of :mod:`apex_tpu_torch.random`).

    ``decode_fn(pools, carry, page_table (max_seqs, pages_per_seq) int32)
    -> (pools, carry)`` produces one token for every live slot; it must
    freeze slots whose ``done`` is set (null-page writes, unchanged
    token / length / budget) and maintain ``done |= sampled == eos or
    budget exhausted``.

    ``chunk_fn(pools, tokens (C,) int32, start, prompt_len, write_from,
    page_row, key) -> (pools, first_token, logits)`` is one
    ``prefill_chunk``-token ingestion step (chunked mode); the first
    token and logits mean something on the chunk holding the last prompt
    token.

    ``spec_fn(pools, carry, page_table, drafts (S, K) int32, draft_len
    (S,) int32) -> (pools, carry, targets (S, K+1), n_commit (S,))`` is
    the verify-and-commit step (``speculate_k=K``); built for a tree
    (``spec_fn.spec_tree``) it takes one draft a non-root node and also
    returns each slot's accepted ``path``.

    :meth:`apex_tpu_torch.models.gpt.GPTModel.decode_fns` builds them
    all.  The pools' device is the serving device.  ``key`` (a host key
    of :mod:`apex_tpu_torch.random`, default ``PRNGKey(0)``) seeds the
    streams of requests without a ``seed``.
    """

    def __init__(
        self,
        prefill_fn: Callable,
        decode_fn: Callable,
        cache: PagedKVCache,
        pools: Dict[str, torch.Tensor],
        *,
        max_prompt_len: int,
        harvest_every: int = 8,
        eos_id: Optional[int] = None,
        logger: Optional[Any] = None,
        chunk_fn: Optional[Callable] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        measure_stall: bool = False,
        spec_fn: Optional[Callable] = None,
        speculate_k: Optional[int] = None,
        draft_source: Optional[Any] = None,
        offload: Optional[HostOffloadPool] = None,
        key: Optional[Any] = None,
    ):
        if harvest_every < 1:
            raise ValueError("harvest_every must be >= 1")
        if offload is not None and not prefix_cache:
            raise ValueError(
                "offload requires prefix_cache=True (the offload tier "
                "keys staged pages by prefix hash; without the index "
                "nothing could fault them back)")
        # the device step freezes slots at ITS eos id; the host truncates
        # at THIS one — a decode_fn that declares its id must agree
        _unset = object()
        fn_eos = getattr(decode_fn, "eos_id", _unset)
        if fn_eos is not _unset and fn_eos != eos_id:
            raise ValueError(
                f"eos_id mismatch: decode_fn freezes slots at "
                f"{fn_eos!r} but the batcher truncates at {eos_id!r} — "
                "pass the same eos_id to decode_fns() and "
                "ContinuousBatcher()")
        if (prefill_chunk is None) != (chunk_fn is None):
            raise ValueError(
                "chunked prefill needs BOTH chunk_fn and prefill_chunk "
                "(decode_fns(prefill_chunk=C) builds the pair)")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        fn_chunk = getattr(chunk_fn, "prefill_chunk", _unset)
        if chunk_fn is not None and fn_chunk is not _unset and \
                int(fn_chunk) != int(prefill_chunk):
            raise ValueError(
                f"prefill_chunk mismatch: chunk_fn was compiled for "
                f"{fn_chunk}-token chunks but the batcher schedules "
                f"{prefill_chunk}-token chunks")
        if prefix_cache and prefill_chunk is None:
            raise ValueError(
                "prefix_cache requires chunked prefill (the monolithic "
                "prefill recomputes every position and cannot skip "
                "matched chunks)")
        if (spec_fn is None) != (speculate_k is None):
            raise ValueError(
                "speculative decoding needs BOTH spec_fn and "
                "speculate_k (decode_fns(speculate_k=K) builds the "
                "pair)")
        if spec_fn is not None:
            if int(speculate_k) < 1:
                raise ValueError(
                    f"speculate_k must be >= 1, got {speculate_k}")
            fn_k = getattr(spec_fn, "speculate_k", _unset)
            if fn_k is not _unset and int(fn_k) != int(speculate_k):
                raise ValueError(
                    f"speculate_k mismatch: spec_fn was compiled for "
                    f"k={fn_k} drafts but the batcher schedules "
                    f"k={speculate_k}")
            fn_spec_eos = getattr(spec_fn, "eos_id", _unset)
            if fn_spec_eos is not _unset and fn_spec_eos != eos_id:
                raise ValueError(
                    f"eos_id mismatch: spec_fn freezes slots at "
                    f"{fn_spec_eos!r} but the batcher truncates at "
                    f"{eos_id!r}")
        if draft_source is not None and spec_fn is None:
            raise ValueError(
                "draft_source without spec_fn — pass "
                "decode_fns(speculate_k=K)'s spec step too")
        self.spec_fn = spec_fn
        self.speculate_k = (None if speculate_k is None
                            else int(speculate_k))
        #: the candidate tree spec_fn verifies (None: a chain)
        self.spec_tree = getattr(spec_fn, "spec_tree", None)
        self._tree_chain_rows: tuple = ()
        if self.spec_tree is not None:
            self.spec_tree = tuple(int(p) for p in self.spec_tree)
            self._tree_chain_rows = tree_chain_rows(self.spec_tree)
        if spec_fn is not None and draft_source is None:
            # a draft model bound at decode_fns(draft_model=...) rides the
            # step into the batcher; n-gram self-speculation is the default
            draft_source = getattr(spec_fn, "draft_source", None)
        if spec_fn is not None and draft_source is None:
            draft_source = NGramDraftSource(self.speculate_k)
        if draft_source is not None:
            ds_tree = getattr(draft_source, "tree", None)
            if ds_tree is not None and self.spec_tree is not None and \
                    tuple(int(p) for p in ds_tree) != self.spec_tree:
                raise ValueError(
                    "draft_source drafts for a different candidate "
                    f"tree ({tuple(ds_tree)}) than spec_fn verifies "
                    f"({self.spec_tree}) — rebuild one of them")
            if ds_tree is not None and self.spec_tree is None:
                raise ValueError(
                    "draft_source drafts a candidate tree but spec_fn "
                    "verifies a chain — pass the same tree to "
                    "decode_fns(spec_tree=...)")
        self.draft_source = draft_source
        #: host-side speculation scoreboard: per-verify-step totals, hits
        #: by draft source, commits off a tree's first-child chain, and
        #: host draft time
        self.spec_stats = {
            "steps": 0, "slot_steps": 0, "drafted": 0, "accepted": 0,
            "committed": 0, "by_source": {}, "offramp": 0, "draft_s": 0.0,
        }
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.chunk_fn = chunk_fn
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        #: brownout levers (the fleet's ladder drives them): with
        #: ``speculation_enabled`` off the windows decode one token a step
        #: (the spec step stays built); ``chunk_throttle=N`` runs a
        #: prefill chunk on every Nth window iteration.  Scheduling only:
        #: the key schedule folds context length, not step timing.
        self.speculation_enabled = True
        self.chunk_throttle = 1
        self._chunk_tick = 0
        #: the disaggregation lever: a prefill-role replica runs chunks and
        #: resolves first tokens but never dispatches a decode or verify
        #: step; its prompt-complete slots wait for the fleet's handoff
        self.decode_enabled = True
        self.prefix_cache = bool(prefix_cache)
        self.measure_stall = bool(measure_stall)
        self.logger = logger
        # the decode step's declared weight stream and tensor-parallel
        # degree, stamped on each decode span
        self.weight_dtype = getattr(decode_fn, "weight_dtype", None)
        self.weight_stream_bytes = getattr(
            decode_fn, "weight_stream_bytes", None)
        self.tp = getattr(decode_fn, "tp", 1)
        self.cache = cache
        self.pools = pools
        self.device = pools["k"].device
        #: host-RAM tier for evicted prefix pages, on the cache's GC seam
        self.offload = offload
        if offload is not None:
            cache.evict_hook = self._stage_to_offload
        self.max_prompt_len = int(max_prompt_len)
        self.harvest_every = int(harvest_every)
        self.eos_id = eos_id
        self._base_key = PRNGKey(0) if key is None else np.asarray(
            key, dtype=np.uint32)
        self._n_admits = 0
        self.carry = init_carry(cache.config.max_seqs, self._base_key,
                                self.device)
        self._meta: Dict[int, dict] = {}      # slot -> request meta
        self._prefilling: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()         # slot -> chunk progress
        self._first_tok: Dict[int, torch.Tensor] = {}
        self.completions: Dict[Any, Completion] = {}
        self.steps = 0
        self.windows = 0
        self.prefill_chunks = 0
        #: prefill wall time spent while >= 1 decoding slot was live (in
        #: total, and the worst single stall): meaningful under
        #: ``measure_stall``, which synchronises around each dispatch
        self.decode_stall_s = 0.0
        self.max_prefill_stall_s = 0.0
        #: logits of the last completed chunked prefill's last prompt
        #: token: what the prefix-hit bit-identity checks compare
        self.last_prefill_logits: Optional[torch.Tensor] = None
        self.prefix_stats = {
            "admissions": 0, "hits": 0, "matched_tokens": 0,
            "shared_pages": 0, "tokens_skipped": 0, "copied_pages": 0,
        }

    # ------------------------------------------------------------ events
    def _event(self, kind: str, **fields) -> None:
        if self.logger is not None:
            self.logger.event(kind, **fields)

    def _weight_fields(self) -> dict:
        """The decode span's weight-stream fields (only when the decode
        step declared its pool): the width label, the bytes one step
        streams (``steps * weight_bytes / dur_s`` is the window's
        weight-stream GB/s) and the tensor-parallel degree."""
        if self.weight_dtype is None:
            return {}
        f = {"weight_dtype": self.weight_dtype}
        if self.weight_stream_bytes is not None:
            f["weight_bytes"] = int(self.weight_stream_bytes)
        if self.tp is not None:
            f["tp"] = int(self.tp)
        return f

    def _emit_gauges(self, queue_depth: int) -> None:
        """The serving load gauges (``pages_free`` / ``pages_shared`` /
        ``live_slots`` / ``queue_depth``): host mirrors, no device
        synchronisation; the signals the fleet router scores replicas
        by."""
        if self.logger is None:
            return
        self.logger.gauge("pages_free", self.cache.allocator.num_free)
        self.logger.gauge("pages_shared", self.cache.allocator.num_shared)
        self.logger.gauge("live_slots", self.live_slots)
        self.logger.gauge("queue_depth", int(queue_depth))

    # ------------------------------------------------------ host mirrors
    @property
    def live_slots(self) -> int:
        """Slots decoding or prefilling (host state only)."""
        return len(self._meta) + len(self._prefilling)

    @property
    def pending_prefill_chunks(self) -> int:
        """Prefill chunks still to run for in-flight admissions (host
        state only)."""
        if self.prefill_chunk is None:
            return len(self._prefilling)
        C = self.prefill_chunk
        return sum(max(-(-st["plen"] // C) - st["next_chunk"], 0)
                   for st in self._prefilling.values())

    def progress(self) -> Dict[Any, List[int]]:
        """Harvested tokens so far for every in-flight request (uid ->
        committed tokens; a still-prefilling request maps to ``[]``).
        Tokens a later harvest would surface are not included."""
        out: Dict[Any, List[int]] = {
            m["req"].uid: list(m["tokens"]) for m in self._meta.values()}
        for st in self._prefilling.values():
            out[st["req"].uid] = []
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed_prefill(self, fn, *args):
        """Run one prefill dispatch: ``(outputs, seconds)``.  Under
        ``measure_stall`` the device queue is drained first and after, so
        the time is this prefill's work, and it counts as a stall if a
        decoding slot was live."""
        with phase("prefill"):
            if self.measure_stall:
                self._sync()
            t0 = time.perf_counter()
            out = fn(*args)
            if self.measure_stall:
                self._sync()
            dur = time.perf_counter() - t0
        if any(m["finished"] is None for m in self._meta.values()):
            self.decode_stall_s += dur
            self.max_prefill_stall_s = max(self.max_prefill_stall_s, dur)
        return out, dur

    # ------------------------------------------------------------- admit
    def _slot_key(self, req: Request) -> np.ndarray:
        """The request's sampling key: its own seed when given, else a
        fold of the server key by admission index."""
        if req.seed is not None:
            return PRNGKey(int(req.seed))
        return fold_in(self._base_key, self._n_admits)

    def _slot_live(self, slot: int, first: torch.Tensor, req: Request,
                   plen: int, t_admit: float, skey) -> None:
        """Prefill finished: flip the slot into the decoding set (device
        carry updated in place, no host sync)."""
        budget_left = req.max_new_tokens - 1
        c = self.carry
        c["tokens"][slot] = first
        c["lengths"][slot] = plen
        c["steps_left"][slot] = budget_left
        c["done"][slot] = budget_left <= 0
        c["sample_keys"][slot] = keys_tensor(skey, self.device)[0]
        self._first_tok[slot] = first
        self._meta[slot] = {
            "req": req, "tokens": [], "t_admit": t_admit,
            "t_first": None, "finished": None,
            # decode steps before this mark predate the slot's join
            "since_step": self.steps,
        }

    def _admit(self, queue) -> None:
        cfg = self.cache.config
        free = [s for s in range(cfg.max_seqs)
                if s not in self._meta and s not in self._prefilling]
        for slot in free:
            if not queue:
                break
            req = queue[0]
            plen = len(req.prompt)
            if plen > self.max_prompt_len:
                raise ValueError(
                    f"prompt of {plen} tokens exceeds max_prompt_len "
                    f"{self.max_prompt_len}")
            if self.offload is not None and len(self.offload):
                # fault offloaded prefix pages back before the match, so
                # admit() shares them and their chunks are skipped
                self._fault_in(req.prompt)
            try:
                res = self.cache.admit(
                    slot, plen + req.max_new_tokens,
                    prompt_tokens=(req.prompt if self.prefix_cache
                                   else None))
            except CacheOutOfPages:
                break                       # backpressure: wait for pages
            queue.popleft()
            skey = self._slot_key(req)
            self._n_admits += 1
            t_admit = time.perf_counter()
            page_row = torch.as_tensor(self.cache.page_table[slot],
                                       device=self.device)
            self._event("request_admitted", uid=req.uid, slot=slot,
                        prompt_tokens=plen, budget=req.max_new_tokens)
            if self.prefill_chunk is not None:
                self._admit_chunked(slot, req, res, skey, t_admit,
                                    page_row)
                continue
            toks = torch.zeros((1, self.max_prompt_len), dtype=torch.int32)
            toks[0, :plen] = torch.as_tensor(list(req.prompt),
                                             dtype=torch.int32)
            (self.pools, first), dispatch_s = self._timed_prefill(
                self.prefill_fn, self.pools, toks.to(self.device), plen,
                page_row, skey)
            self.cache.lengths[slot] = plen
            self._slot_live(slot, first, req, plen, t_admit, skey)
            self._event("span", span="prefill", slot=slot, tokens=plen,
                        dispatch_s=round(dispatch_s, 6))
        self._emit_gauges(len(queue))

    def _admit_chunked(self, slot, req, res, skey, t_admit,
                       page_row) -> None:
        C = self.prefill_chunk
        plen = len(req.prompt)
        if res.copied_page is not None:
            # copy-on-write: the match ended inside this page; the shared
            # source stays read-only, the copy becomes the slot's tail
            src, dst = res.copied_page
            copy_pages(self.pools, [src], [dst])
        n_chunks = -(-plen // C)
        toks = np.zeros((n_chunks * C,), np.int32)
        toks[:plen] = np.asarray(req.prompt, np.int32)
        first_chunk = res.matched_tokens // C
        self._prefilling[slot] = {
            "req": req, "toks": toks, "plen": plen,
            "next_chunk": first_chunk, "write_from": res.matched_tokens,
            "skipped": first_chunk * C,
            "hashes": res.page_hashes, "key": skey, "t_admit": t_admit,
            "chunk_s": 0.0, "page_row": page_row,
        }
        if self.prefix_cache:
            st = self.prefix_stats
            st["admissions"] += 1
            if res.matched_tokens:
                st["hits"] += 1
            st["matched_tokens"] += res.matched_tokens
            st["shared_pages"] += res.shared_pages
            st["tokens_skipped"] += first_chunk * C
            if res.copied_page is not None:
                st["copied_pages"] += 1
            self._event(
                "prefix_hit", uid=req.uid, slot=slot,
                matched_tokens=res.matched_tokens,
                shared_pages=res.shared_pages,
                tokens_skipped=first_chunk * C,
                copied=res.copied_page is not None)

    # ----------------------------------------------------- prefill chunk
    def _prefill_step(self, slot: int) -> float:
        """Run ONE chunk of the oldest in-flight admission; on the last
        chunk the slot joins the decoding set with its sampled first
        token.  Returns the chunk's dispatch time, which the window keeps
        out of the decode span's duration."""
        st = self._prefilling[slot]
        C = self.prefill_chunk
        c0 = st["next_chunk"] * C
        (self.pools, tok, logits), dur = self._timed_prefill(
            self.chunk_fn, self.pools, st["toks"][c0:c0 + C], c0,
            st["plen"], st["write_from"], st["page_row"], st["key"])
        st["chunk_s"] += dur
        st["next_chunk"] += 1
        self.prefill_chunks += 1
        self._event("span", span="prefill_chunk", slot=slot,
                    chunk=st["next_chunk"] - 1, start=c0,
                    tokens=min(C, st["plen"] - c0),
                    dispatch_s=round(dur, 6))
        if st["next_chunk"] * C < st["plen"]:
            return dur
        # last chunk: the prompt is fully ingested
        req = st["req"]
        del self._prefilling[slot]
        self.cache.lengths[slot] = st["plen"]
        if self.prefix_cache:
            self.cache.register_prefix(slot, req.prompt,
                                       hashes=st["hashes"])
        self.last_prefill_logits = logits
        self._slot_live(slot, tok, req, st["plen"], st["t_admit"],
                        st["key"])
        self._event("span", span="prefill", slot=slot,
                    tokens=st["plen"] - st["skipped"],
                    dispatch_s=round(st["chunk_s"], 6))
        return dur

    # ------------------------------------------------------------ decode
    def _window_budget(self, base: int) -> int:
        """Decode steps someone can still use: the longest remaining
        budget among live slots, net of the steps each already took this
        window (the admit-time first token counts while it is still an
        unharvested device value).  One-token-per-step arithmetic: the
        speculative window counts by host instead."""
        budget = 0
        for s, m in self._meta.items():
            if m["finished"] is not None:
                continue
            taken = self.steps - max(m["since_step"], base)
            rem = (m["req"].max_new_tokens - len(m["tokens"])
                   - (1 if s in self._first_tok else 0) - taken)
            budget = max(budget, rem)
        return budget

    def _note_token(self, m: dict, tok: int, slot: int) -> None:
        """Append one harvested token to a slot's host stream; the host
        length mirror follows the device's write position."""
        m["tokens"].append(tok)
        self.cache.lengths[slot] += 1
        if self.eos_id is not None and tok == self.eos_id:
            m["finished"] = "eos"
        elif len(m["tokens"]) >= m["req"].max_new_tokens:
            m["finished"] = "budget"

    def _absorb_firsts(self, firsts_h: Dict[int, int], t_h: float) -> None:
        for slot, tok in firsts_h.items():
            m = self._meta[slot]
            m["tokens"].append(tok)
            m["t_first"] = t_h
            if self.eos_id is not None and tok == self.eos_id:
                m["finished"] = "eos"
            elif len(m["tokens"]) >= m["req"].max_new_tokens:
                m["finished"] = "budget"

    def _retire(self, done_h, t_h: float) -> None:
        """Retire finished slots: the device's ``done`` and the host's
        finish detection agree by construction (same eos/budget rules);
        the host is authoritative for truncation, the device for
        freezing."""
        for slot in list(self._meta):
            m = self._meta[slot]
            if m["finished"] is None and not bool(done_h[slot]):
                continue
            reason = m["finished"] or (
                "eos" if (self.eos_id is not None and m["tokens"]
                          and m["tokens"][-1] == self.eos_id)
                else "budget")
            req = m["req"]
            comp = Completion(
                uid=req.uid, tokens=m["tokens"],
                prompt_len=len(req.prompt), reason=reason,
                ttft_s=(None if m["t_first"] is None
                        else m["t_first"] - m["t_admit"]),
                duration_s=t_h - m["t_admit"],
            )
            self.completions[req.uid] = comp
            self.cache.retire(slot)
            self.carry["done"][slot] = True
            del self._meta[slot]
            self._event("request_done", uid=req.uid, slot=slot,
                        new_tokens=len(comp.tokens), reason=reason,
                        ttft_s=(None if comp.ttft_s is None
                                else round(comp.ttft_s, 6)),
                        duration_s=round(comp.duration_s, 6))

    def _spec_window(self) -> None:
        """One window of speculative serving steps: draft on the host,
        verify and commit on the device, resolve the commits at once (the
        next draft needs them: one small sync a verify step).  Budgets
        are exact host counts, and a draft is capped at the slot's
        remaining budget - 1, so no live row is written past its pages."""
        k = self.speculate_k
        S = self.cache.config.max_seqs
        tree = self.spec_tree
        # a chain offers k draft columns, a tree one per non-root node
        n_cols = k if tree is None else len(tree) - 1
        chain_rows = self._tree_chain_rows
        chain_set = set(chain_rows)
        page_table = torch.as_tensor(self.cache.page_table,
                                     device=self.device)
        t0 = time.perf_counter()
        chunk_s = draft_s = 0.0
        steps = kept = 0
        done_h = None
        for _ in range(self.harvest_every):
            did_chunk, dur = self._chunk_turn()
            chunk_s += dur
            # resolve pending first tokens now: a draft needs the whole
            # committed context
            if self._first_tok:
                slots = list(self._first_tok)
                firsts = _device_get(torch.stack(
                    [self._first_tok.pop(s) for s in slots])).tolist()
                self._absorb_firsts(dict(zip(slots, firsts)),
                                    time.perf_counter())
            # a prefill-role replica stops here: no verify step, its
            # slots wait for the handoff
            if not self.decode_enabled:
                if not did_chunk:
                    break
                continue
            live = [(s, m) for s, m in self._meta.items()
                    if m["finished"] is None]
            if not live:
                if not did_chunk:
                    break
                continue
            drafts = np.zeros((S, n_cols), np.int32)
            dlens = np.zeros((S,), np.int32)
            sources: Dict[int, str] = {}
            for s, m in live:
                rem = m["req"].max_new_tokens - len(m["tokens"])
                cap = min(k, rem - 1)
                if cap <= 0:
                    continue
                td = time.perf_counter()
                toks, src = self.draft_source.draft(
                    list(m["req"].prompt) + m["tokens"],
                    len(m["req"].prompt))
                draft_s += time.perf_counter() - td
                if tree is not None and len(toks) == n_cols:
                    # a tree-aware source: one token a non-root node, in
                    # row order; the device's depth mask trims past cap
                    drafts[s, :] = toks
                    dlens[s] = min(k, cap)
                    sources[s] = src
                    continue
                toks = toks[:cap]
                if toks:
                    if tree is None:
                        drafts[s, :len(toks)] = toks
                    else:
                        # a chain source under a tree verify: the chain
                        # goes on the tree's first-child rows
                        for i, row in enumerate(chain_rows[:len(toks)]):
                            drafts[s, row - 1] = toks[i]
                    dlens[s] = len(toks)
                    sources[s] = src
            with phase("decode"):
                out = self.spec_fn(self.pools, self.carry, page_table,
                                   drafts, dlens)
            if tree is None:
                self.pools, self.carry, targets, n_commit = out
                parts = [targets, n_commit]
            else:
                self.pools, self.carry, targets, n_commit, path = out
                parts = [targets, n_commit, path]
            resolved = _device_get(
                parts + [self.carry["done"].to(torch.int32)])
            out_h, nc_h = resolved[0].tolist(), resolved[1].tolist()
            path_h = resolved[2].tolist() if tree is not None else None
            done_h = resolved[-1].tolist()
            self.steps += 1
            steps += 1
            drafted = accepted = committed = offramp = 0
            commits: List[int] = []
            ev_src: Dict[str, Dict[str, int]] = {}
            for s, m in live:
                nc = int(nc_h[s])
                for j in range(nc):
                    self._note_token(m, int(out_h[s][j]), s)
                kept += nc
                dl = int(dlens[s])
                acc = max(min(nc - 1, dl), 0)
                if path_h is not None:
                    # committed nodes off the first-child chain: tokens a
                    # chain verify would have rejected
                    offramp += sum(
                        1 for t in range(1, acc + 1)
                        if int(path_h[s][t]) not in chain_set)
                drafted += dl
                accepted += acc
                committed += nc
                commits.append(nc)
                src = sources.get(s)
                if src is not None:
                    rec = ev_src.setdefault(
                        src, {"drafted": 0, "accepted": 0})
                    rec["drafted"] += dl
                    rec["accepted"] += acc
            st = self.spec_stats
            st["steps"] += 1
            st["slot_steps"] += len(live)
            st["drafted"] += drafted
            st["accepted"] += accepted
            st["committed"] += committed
            st["offramp"] += offramp
            for src, rec in ev_src.items():
                tot = st["by_source"].setdefault(
                    src, {"drafted": 0, "accepted": 0})
                tot["drafted"] += rec["drafted"]
                tot["accepted"] += rec["accepted"]
            # one spec_accept event a verify step, from the commit
            # resolve this loop already made
            self._event("spec_accept", slots=len(live),
                        drafted=drafted, accepted=accepted,
                        committed=committed, commits=commits,
                        by_source=ev_src, offramp=offramp)
        t_h = time.perf_counter()
        self.windows += 1
        self.spec_stats["draft_s"] += draft_s
        if done_h is None:
            done_h = _device_get(self.carry["done"]).tolist()
        self._event(
            "span", span="decode", steps=steps,
            slots=len(self._meta), tokens=kept,
            dur_s=round(max(t_h - t0 - chunk_s, 0.0), 6),
            draft_s=round(draft_s, 6),
            **self._weight_fields(),
        )
        self._retire(done_h, t_h)

    def _chunk_turn(self) -> Tuple[bool, float]:
        """A window iteration's prefill budget: at most one chunk of the
        oldest admission, on every ``chunk_throttle``-th iteration.
        ``(whether a chunk ran, its dispatch seconds)``."""
        if not self._prefilling:
            return False, 0.0
        self._chunk_tick += 1
        if self._chunk_tick % max(1, self.chunk_throttle):
            return False, 0.0
        return True, self._prefill_step(next(iter(self._prefilling)))

    def _decode_window(self) -> None:
        if self.spec_fn is not None and self.speculation_enabled:
            return self._spec_window()
        base = self.steps
        page_table = torch.as_tensor(self.cache.page_table,
                                     device=self.device)
        window: List[torch.Tensor] = []
        t0 = time.perf_counter()
        chunk_s = 0.0      # interleaved prefill time, kept out of dur_s
        for _ in range(self.harvest_every):
            # a step's token budget: at most ONE prefill chunk ...
            did_chunk, dur = self._chunk_turn()
            chunk_s += dur
            # ... plus one decode token for every live slot (a
            # prefill-role replica never decodes: its slots wait for the
            # handoff)
            if self.decode_enabled and self._window_budget(base) > 0:
                with phase("decode"):
                    self.pools, self.carry = self.decode_fn(
                        self.pools, self.carry, page_table)
                # a replayed step's carry is the graph's buffer, which
                # the next step overwrites
                window.append(self.carry["tokens"].clone())
                self.steps += 1
            elif not did_chunk:
                break
        # ---- harvest: ONE device-to-host copy for the window's tokens,
        # the pending first tokens and the done flags
        steps = len(window)
        slots = list(self._first_tok)
        S = self.cache.config.max_seqs
        parts = window + [torch.stack([self._first_tok.pop(s)
                                       for s in slots]).reshape(-1)
                          if slots else self.carry["tokens"][:0],
                          self.carry["done"].to(torch.int32)]
        flat = _device_get(torch.cat([p.reshape(-1).to(torch.int32)
                                      for p in parts])).tolist()
        t_h = time.perf_counter()
        self.windows += 1
        harvested = [flat[i * S:(i + 1) * S] for i in range(steps)]
        firsts_h = dict(zip(slots, flat[steps * S: steps * S + len(slots)]))
        done_h = flat[steps * S + len(slots):]

        self._absorb_firsts(firsts_h, t_h)
        kept = 0
        for i in range(steps):
            for slot, m in self._meta.items():
                if m["finished"] is not None:
                    continue
                if base + i < m["since_step"]:
                    continue        # slot joined after this step
                self._note_token(m, harvested[i][slot], slot)
                kept += 1
        # tokens = kept tokens only (a slot that finished mid-window
        # decodes garbage for the rest of it); dur_s leaves out the
        # interleaved chunks, which are spans of their own
        self._event(
            "span", span="decode", steps=steps,
            slots=len(self._meta), tokens=kept,
            dur_s=round(max(t_h - t0 - chunk_s, 0.0), 6),
            **self._weight_fields(),
        )
        self._retire(done_h, t_h)

    # ----------------------------------------------------- offload tier
    def _stage_to_offload(self, victims) -> None:
        """The cache's ``evict_hook``: the refcount GC is about to free a
        burst of index-only pages; their bytes cross to the host tier in
        ONE device-to-host copy, and each entry keeps a copy of its own
        page (not a view holding the whole burst).  The copies are
        pageable: on an H100's host, pinned page buffers cost more in
        allocation than their faster copies back saved."""
        staged = export_pages(self.pools, [p for _, _, p in victims])
        for i, (h, parent, _) in enumerate(victims):
            self.offload.put(h, parent, {
                k: v[:, i:i + 1].clone() for k, v in staged.items()})
        self._event("page_offload", pages=len(victims),
                    bytes=staged_nbytes(staged))

    def _fault_in(self, prompt) -> None:
        """Bring a prompt's offloaded prefix pages back: walk the
        cumulative hash chain, and for each hash not resident but staged
        in the host tier adopt a fresh page into the prefix index and
        scatter the staged bytes into it, bit-identical to a page that
        never left.  Stops at the first hash neither tier holds.  The
        walked chain is protected from the GC the adoption may run."""
        cache = self.cache
        hashes = prompt_page_hashes(prompt, cache.config.page_size)
        chain: set = set()
        prev = None
        batch: List[Any] = []
        n_bytes = misses = 0
        t0 = time.perf_counter()
        for h in hashes:
            chain.add(h)
            if h in cache._prefix:
                prev = h
                continue
            if h not in self.offload:
                misses += 1
                self.offload.stats["misses"] += 1
                break
            try:
                page = cache.adopt_prefix_page(h, prev, protect=chain)
            except CacheOutOfPages:
                break               # the pool is full of live pages
            entry = self.offload.take(h)
            batch.append((page, entry["data"]))
            n_bytes += staged_nbytes(entry["data"])
            prev = h
        pages_in = len(batch)
        if batch:
            self._import_chain(batch)
        if pages_in or misses:
            self._event(
                "page_faultin", pages=pages_in, bytes=n_bytes,
                tokens=pages_in * cache.config.page_size, misses=misses,
                dur_s=round(time.perf_counter() - t0, 6))

    def _import_chain(self, batch: List[Any]) -> None:
        """Scatter a faulted-in chain's staged pages into their new
        pages."""
        cache = self.cache
        # one import for the chain, padded to a power-of-two page count
        # by repeating the last page (same bytes at a duplicate index).
        # The buckets are JAX's, where they bound the jitted scatter's
        # compiles; the eager scatter here compiles nothing, and the
        # padding is a copy on the device.  The pages cross to the device
        # one entry at a time and are joined there: no host-side join
        dev = self.pools["k"].device
        pages = [p for p, _ in batch]
        staged = {k: torch.cat([d[k].to(dev, non_blocking=True)
                                for _, d in batch], dim=1)
                  for k in batch[0][1]}
        bucket = min(1 << (len(pages) - 1).bit_length(),
                     cache.config.pages_per_seq)
        if bucket > len(pages):
            pad = bucket - len(pages)
            pages = pages + [pages[-1]] * pad
            staged = {k: torch.cat([v] + [v[:, -1:]] * pad, dim=1)
                      for k, v in staged.items()}
        import_pages(self.pools, staged, pages)

    # ------------------------------------------------- handoff (fleet)
    def handoff_ready(self) -> List[Any]:
        """Uids exportable now: prompt ingested, first token committed to
        the host stream, stream unfinished."""
        return [m["req"].uid for s, m in self._meta.items()
                if m["finished"] is None and m["tokens"]
                and s not in self._first_tok]

    def export_request(self, uid: Any) -> Optional[HandoffPacket]:
        """Package an in-flight request's decode state for another
        replica: stage every KV page written so far on the host and
        release the slot (no :class:`Completion`: ownership moves).
        ``None`` when ``uid`` is not exportable (:meth:`handoff_ready`).
        The caller journals the transfer first: after this call the pages
        live only in the packet."""
        slot = next((s for s, m in self._meta.items()
                     if m["req"].uid == uid), None)
        if slot is None:
            return None
        m = self._meta[slot]
        if m["finished"] is not None or not m["tokens"] \
                or slot in self._first_tok:
            return None
        req = m["req"]
        cfg = self.cache.config
        # the host length mirror == positions written on the device:
        # prompt + committed - 1 (the destination writes the newest)
        written = int(self.cache.lengths[slot])
        n_pages = cfg.tokens_to_pages(written)
        # exactly the written pages: JAX pads to a power-of-two count so
        # its jitted scatter compiles once a bucket; the eager gather and
        # scatter here compile nothing, and padding would only copy more
        pages = list(self.cache._slot_pages[slot][:n_pages])
        staged = export_pages(self.pools, pages)
        packet = HandoffPacket(
            req=req, tokens=list(m["tokens"]), staged=staged,
            n_pages=n_pages, written=written,
            wire_bytes=staged_nbytes(staged),
            compat_key=self.cache.compat_key(),
            hashes=(prompt_page_hashes(req.prompt, cfg.page_size)
                    if self.prefix_cache else None))
        del self._meta[slot]
        self.cache.retire(slot)
        self.carry["done"][slot] = True
        self._event("request_exported", uid=req.uid, slot=slot,
                    pages=n_pages, bytes=packet.wire_bytes,
                    tokens=len(packet.tokens))
        return packet

    def import_request(self, packet: HandoffPacket) -> bool:
        """Adopt a :class:`HandoffPacket` into a free slot: pages for the
        whole prompt + budget, the staged bytes scattered into the leading
        ``n_pages`` of them, and decoding resumed from the packet's last
        token at the position the source left off (no recompute).
        ``False`` on backpressure (no free slot or pages): the packet
        stays valid."""
        if packet.compat_key != self.cache.compat_key():
            raise ValueError(
                f"handoff across incompatible cache families: packet "
                f"{packet.compat_key} vs pool "
                f"{self.cache.compat_key()}: pages cannot move "
                "between different page layouts")
        req = packet.req
        plen = len(req.prompt)
        if plen > self.max_prompt_len:
            raise ValueError(
                f"prompt of {plen} tokens exceeds max_prompt_len "
                f"{self.max_prompt_len}")
        cfg = self.cache.config
        slot = next((s for s in range(cfg.max_seqs)
                     if s not in self._meta
                     and s not in self._prefilling), None)
        if slot is None:
            return False
        try:
            self.cache.admit(slot, plen + req.max_new_tokens)
        except CacheOutOfPages:
            return False
        pages = list(self.cache._slot_pages[slot][:packet.n_pages])
        n_tok = len(packet.tokens)
        last = int(packet.tokens[-1])
        budget_left = req.max_new_tokens - n_tok
        finished = None
        if self.eos_id is not None and last == self.eos_id:
            finished = "eos"
        elif budget_left <= 0:
            finished = "budget"
        self.cache.lengths[slot] = packet.written
        skey = self._slot_key(req)
        self._n_admits += 1
        _import_state(self.pools, self.carry, packet.staged, pages, slot,
                     last, packet.written, budget_left, finished is not None,
                     skey)
        now = time.perf_counter()
        self._meta[slot] = {
            "req": req, "tokens": list(packet.tokens),
            # TTFT happened on the source; the fleet log keeps the times
            "t_admit": now, "t_first": now, "finished": finished,
            "since_step": self.steps,
        }
        if self.prefix_cache and packet.hashes:
            # the pages keep the hashes they were registered under
            self.cache.register_prefix(slot, req.prompt,
                                       hashes=packet.hashes)
        self._event("request_imported", uid=req.uid, slot=slot,
                    pages=packet.n_pages, bytes=packet.wire_bytes,
                    tokens=n_tok)
        return True

    # ------------------------------------------------------------ cancel
    def cancel(self, uid: Any) -> Optional[List[int]]:
        """Evict an in-flight request: release its slot and page
        references and freeze its carry row.  Returns the tokens harvested
        so far (``[]`` while it is still prefilling), or ``None`` when
        ``uid`` is not in flight; no :class:`Completion` is recorded, so
        the uid can be served again.  Tokens an unharvested window made
        are dropped: harvest is the commit point."""
        for slot, m in self._meta.items():
            if m["req"].uid != uid:
                continue
            self._first_tok.pop(slot, None)
            tokens = list(m["tokens"])
            del self._meta[slot]
            self.cache.retire(slot)
            self.carry["done"][slot] = True
            self._event("request_cancelled", uid=uid, slot=slot,
                        new_tokens=len(tokens))
            return tokens
        for slot, st in self._prefilling.items():
            if st["req"].uid != uid:
                continue
            del self._prefilling[slot]
            self.cache.retire(slot)
            self._event("request_cancelled", uid=uid, slot=slot,
                        new_tokens=0)
            return []
        return None

    # -------------------------------------------------------------- pump
    def pump(self, queue) -> bool:
        """ONE scheduler turn over an external ``collections.deque`` of
        :class:`Request`: admit while slots and pages allow (admitted
        entries are popped), then run one harvest window.  Returns True
        while the batcher holds or awaits work: the fleet router's unit
        of interleaving."""
        self._admit(queue)
        if not self._meta and not self._prefilling:
            if queue:
                raise CacheOutOfPages(
                    "no slot can ever admit the next request "
                    f"(prompt+budget needs more pages than the "
                    f"pool holds: {queue[0].uid!r})")
            return False
        self._decode_window()
        return bool(self._meta or self._prefilling or queue)

    # --------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> Dict[Any, Completion]:
        """Serve ``requests`` to completion; returns ``uid ->``
        :class:`Completion`.  Re-entrant: call again with more requests —
        the cache, prefix index, pools and step functions are reused."""
        queue = collections.deque(requests)
        while queue or self._meta or self._prefilling:
            self._admit(queue)
            if not self._meta and not self._prefilling:
                if queue:
                    raise CacheOutOfPages(
                        "no slot can ever admit the next request "
                        f"(prompt+budget needs more pages than the "
                        f"pool holds: {queue[0].uid!r})")
                break
            self._decode_window()
        return self.completions
