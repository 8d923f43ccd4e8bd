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
graph per step shape (``serving/graphs.py``): a step's outputs are the
graph's static buffers, so the window keeps a copy of each step's tokens.

Not ported yet: the metrics logger, and the host offload tier and the
fleet seams (item 8).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.random import PRNGKey, fold_in, keys_tensor
from apex_tpu_torch.serving.kv_cache import (
    CacheOutOfPages,
    PagedKVCache,
    copy_pages,
)
from apex_tpu_torch.serving.speculate import NGramDraftSource, tree_chain_rows
from apex_tpu_torch.telemetry.spans import phase
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["Request", "Completion", "ContinuousBatcher", "init_carry"]


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
        offload: Optional[Any] = None,
        key: Optional[Any] = None,
    ):
        if logger is not None:
            raise NotImplementedError(
                "the metrics logger is not ported yet (ROADMAP.md queue A "
                "item 10, the rest of telemetry)")
        if offload is not None:
            raise NotImplementedError(
                "the host offload tier is not ported yet (ROADMAP.md "
                "queue A item 8)")
        if harvest_every < 1:
            raise ValueError("harvest_every must be >= 1")
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
        self.prefix_cache = bool(prefix_cache)
        self.measure_stall = bool(measure_stall)
        self.cache = cache
        self.pools = pools
        self.device = pools["k"].device
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

    # ------------------------------------------------------ host mirrors
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
        """Run one prefill dispatch; under ``measure_stall`` the device
        queue is drained first and after, so the time is this prefill's
        work, and it counts as a stall if a decoding slot was live."""
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
        return out

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
            if self.prefill_chunk is not None:
                self._admit_chunked(slot, req, res, skey, t_admit,
                                    page_row)
                continue
            toks = torch.zeros((1, self.max_prompt_len), dtype=torch.int32)
            toks[0, :plen] = torch.as_tensor(list(req.prompt),
                                             dtype=torch.int32)
            self.pools, first = self._timed_prefill(
                self.prefill_fn, self.pools, toks.to(self.device), plen,
                page_row, skey)
            self.cache.lengths[slot] = plen
            self._slot_live(slot, first, req, plen, t_admit, skey)

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
            "hashes": res.page_hashes, "key": skey, "t_admit": t_admit,
            "page_row": page_row,
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

    # ----------------------------------------------------- prefill chunk
    def _prefill_step(self, slot: int) -> None:
        """Run ONE chunk of the oldest in-flight admission; on the last
        chunk the slot joins the decoding set with its sampled first
        token."""
        st = self._prefilling[slot]
        C = self.prefill_chunk
        c0 = st["next_chunk"] * C
        self.pools, tok, logits = self._timed_prefill(
            self.chunk_fn, self.pools, st["toks"][c0:c0 + C], c0,
            st["plen"], st["write_from"], st["page_row"], st["key"])
        st["next_chunk"] += 1
        self.prefill_chunks += 1
        if st["next_chunk"] * C < st["plen"]:
            return
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
            self.completions[req.uid] = Completion(
                uid=req.uid, tokens=m["tokens"],
                prompt_len=len(req.prompt), reason=reason,
                ttft_s=(None if m["t_first"] is None
                        else m["t_first"] - m["t_admit"]),
                duration_s=t_h - m["t_admit"],
            )
            self.cache.retire(slot)
            self.carry["done"][slot] = True
            del self._meta[slot]

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
        draft_s = 0.0
        done_h = None
        for _ in range(self.harvest_every):
            did_chunk = False
            if self._prefilling:
                self._prefill_step(next(iter(self._prefilling)))
                did_chunk = True
            # resolve pending first tokens now: a draft needs the whole
            # committed context
            if self._first_tok:
                slots = list(self._first_tok)
                firsts = torch.stack([self._first_tok.pop(s)
                                      for s in slots]).cpu().tolist()
                self._absorb_firsts(dict(zip(slots, firsts)),
                                    time.perf_counter())
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
            resolved = [p.cpu() for p in
                        parts + [self.carry["done"].to(torch.int32)]]
            out_h, nc_h = resolved[0].tolist(), resolved[1].tolist()
            path_h = resolved[2].tolist() if tree is not None else None
            done_h = resolved[-1].tolist()
            self.steps += 1
            st = self.spec_stats
            st["steps"] += 1
            st["slot_steps"] += len(live)
            for s, m in live:
                nc = int(nc_h[s])
                for j in range(nc):
                    self._note_token(m, int(out_h[s][j]), s)
                dl = int(dlens[s])
                acc = max(min(nc - 1, dl), 0)
                if path_h is not None:
                    # committed nodes off the first-child chain: tokens a
                    # chain verify would have rejected
                    st["offramp"] += sum(
                        1 for t in range(1, acc + 1)
                        if int(path_h[s][t]) not in chain_set)
                st["drafted"] += dl
                st["accepted"] += acc
                st["committed"] += nc
                src = sources.get(s)
                if src is not None:
                    rec = st["by_source"].setdefault(
                        src, {"drafted": 0, "accepted": 0})
                    rec["drafted"] += dl
                    rec["accepted"] += acc
        t_h = time.perf_counter()
        self.windows += 1
        self.spec_stats["draft_s"] += draft_s
        if done_h is None:
            done_h = self.carry["done"].cpu().tolist()
        self._retire(done_h, t_h)

    def _decode_window(self) -> None:
        if self.spec_fn is not None:
            return self._spec_window()
        base = self.steps
        page_table = torch.as_tensor(self.cache.page_table,
                                     device=self.device)
        window: List[torch.Tensor] = []
        for _ in range(self.harvest_every):
            # a step's token budget: at most ONE prefill chunk ...
            did_chunk = False
            if self._prefilling:
                self._prefill_step(next(iter(self._prefilling)))
                did_chunk = True
            # ... plus one decode token for every live slot
            if self._window_budget(base) > 0:
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
        flat = torch.cat([p.reshape(-1).to(torch.int32)
                          for p in parts]).cpu().tolist()
        t_h = time.perf_counter()
        self.windows += 1
        harvested = [flat[i * S:(i + 1) * S] for i in range(steps)]
        firsts_h = dict(zip(slots, flat[steps * S: steps * S + len(slots)]))
        done_h = flat[steps * S + len(slots):]

        self._absorb_firsts(firsts_h, t_h)
        for i in range(steps):
            for slot, m in self._meta.items():
                if m["finished"] is not None:
                    continue
                if base + i < m["since_step"]:
                    continue        # slot joined after this step
                self._note_token(m, harvested[i][slot], slot)
        self._retire(done_h, t_h)

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
