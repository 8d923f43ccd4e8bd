"""Continuous batching: admit/retire requests into fixed-shape slots.

Counterpart of ``apex_tpu/serving/serve.py`` in its monolithic mode.  The
driver's steps keep static shapes (``max_seqs`` slots, a
``max_prompt_len`` prompt window, one paged cache) and request churn
only changes contents (page-table rows, length counters, budgets).

Loop anatomy (:meth:`ContinuousBatcher.run`):

1. **admit** — while a slot is free, a request is queued and the page
   allocator has room (``CacheOutOfPages`` is backpressure): reserve
   pages for prompt + budget and run ONE prefill over the padded prompt;
   the slot joins decode at once with its first token still on device.
2. **window** — up to ``harvest_every`` decode steps for all live slots.
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
harvest cadence.

Not ported yet: chunked prefill, the prefix cache and host offload
(ROADMAP.md queue A item 7), speculative decoding (item 7), seeded
sampling (item 3) and the fleet seams (item 8).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from apex_tpu_torch.serving.kv_cache import CacheOutOfPages, PagedKVCache
from apex_tpu_torch.telemetry.spans import phase
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["Request", "Completion", "ContinuousBatcher", "init_carry"]


@dataclasses.dataclass
class Request:
    """One generation request.  ``prompt`` is token ids; generation stops
    after ``max_new_tokens`` or at the server's ``eos_id``."""

    uid: Any
    prompt: Sequence[int]
    max_new_tokens: int

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


def init_carry(max_seqs: int, device=None) -> Dict[str, torch.Tensor]:
    """The decode step's per-slot device state: all slots idle."""
    dev = resolve_device(device)
    s = max_seqs
    return {
        "tokens": torch.zeros((s,), dtype=torch.int32, device=dev),
        "lengths": torch.zeros((s,), dtype=torch.int32, device=dev),
        "steps_left": torch.zeros((s,), dtype=torch.int32, device=dev),
        "done": torch.ones((s,), dtype=torch.bool, device=dev),
    }


class ContinuousBatcher:
    """Drive the serving step functions over a paged cache.

    ``prefill_fn(pools, tokens (1, max_prompt_len) int32, length: int,
    page_row (pages_per_seq,) int32) -> (pools, first_token)`` writes the
    prompt's K/V and samples the first token (a 0-d device tensor).

    ``decode_fn(pools, carry, page_table (max_seqs, pages_per_seq) int32)
    -> (pools, carry)`` produces one token for every live slot; it must
    freeze slots whose ``done`` is set (null-page writes, unchanged
    token / length / budget) and maintain ``done |= sampled == eos or
    budget exhausted``.

    :meth:`apex_tpu_torch.models.gpt.GPTModel.decode_fns` builds both.
    The pools' device is the serving device.
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
        chunk_fn: Optional[Callable] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        spec_fn: Optional[Callable] = None,
        speculate_k: Optional[int] = None,
    ):
        if chunk_fn is not None or prefill_chunk is not None or prefix_cache:
            raise NotImplementedError(
                "chunked prefill and the prefix cache are not ported yet "
                "(ROADMAP.md queue A item 7)")
        if spec_fn is not None or speculate_k is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet "
                "(ROADMAP.md queue A item 7)")
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
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.cache = cache
        self.pools = pools
        self.device = pools["k"].device
        self.max_prompt_len = int(max_prompt_len)
        self.harvest_every = int(harvest_every)
        self.eos_id = eos_id
        self.carry = init_carry(cache.config.max_seqs, self.device)
        self._meta: Dict[int, dict] = {}      # slot -> request meta
        self._first_tok: Dict[int, torch.Tensor] = {}
        self.completions: Dict[Any, Completion] = {}
        self.steps = 0
        self.windows = 0

    # ------------------------------------------------------------- admit
    def _slot_live(self, slot: int, first: torch.Tensor, req: Request,
                   plen: int, t_admit: float) -> None:
        """Prefill finished: flip the slot into the decoding set (device
        carry updated in place, no host sync)."""
        budget_left = req.max_new_tokens - 1
        c = self.carry
        c["tokens"][slot] = first
        c["lengths"][slot] = plen
        c["steps_left"][slot] = budget_left
        c["done"][slot] = budget_left <= 0
        self._first_tok[slot] = first
        self._meta[slot] = {
            "req": req, "tokens": [], "t_admit": t_admit,
            "t_first": None, "finished": None,
            # decode steps before this mark predate the slot's join
            "since_step": self.steps,
        }

    def _admit(self, queue) -> None:
        cfg = self.cache.config
        free = [s for s in range(cfg.max_seqs) if s not in self._meta]
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
                self.cache.admit(slot, plen + req.max_new_tokens)
            except CacheOutOfPages:
                break                       # backpressure: wait for pages
            queue.popleft()
            t_admit = time.perf_counter()
            page_row = torch.as_tensor(self.cache.page_table[slot],
                                       device=self.device)
            toks = torch.zeros((1, self.max_prompt_len), dtype=torch.int32)
            toks[0, :plen] = torch.as_tensor(list(req.prompt),
                                             dtype=torch.int32)
            with phase("prefill"):
                self.pools, first = self.prefill_fn(
                    self.pools, toks.to(self.device), plen, page_row)
            self.cache.lengths[slot] = plen
            self._slot_live(slot, first, req, plen, t_admit)

    # ------------------------------------------------------------ decode
    def _window_budget(self, base: int) -> int:
        """Decode steps someone can still use: the longest remaining
        budget among live slots, net of the steps each already took this
        window (the admit-time first token counts while it is still an
        unharvested device value)."""
        budget = 0
        for s, m in self._meta.items():
            if m["finished"] is not None:
                continue
            taken = self.steps - max(m["since_step"], base)
            rem = (m["req"].max_new_tokens - len(m["tokens"])
                   - (1 if s in self._first_tok else 0) - taken)
            budget = max(budget, rem)
        return budget

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

    def _decode_window(self) -> None:
        base = self.steps
        page_table = torch.as_tensor(self.cache.page_table,
                                     device=self.device)
        window: List[torch.Tensor] = []
        for _ in range(self.harvest_every):
            if self._window_budget(base) <= 0:
                break
            with phase("decode"):
                self.pools, self.carry = self.decode_fn(
                    self.pools, self.carry, page_table)
            window.append(self.carry["tokens"])
            self.steps += 1
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
                tok = harvested[i][slot]
                m["tokens"].append(tok)
                # host length mirror follows the device's write position
                self.cache.lengths[slot] += 1
                if self.eos_id is not None and tok == self.eos_id:
                    m["finished"] = "eos"
                elif len(m["tokens"]) >= m["req"].max_new_tokens:
                    m["finished"] = "budget"
        self._retire(done_h, t_h)

    # --------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> Dict[Any, Completion]:
        """Serve ``requests`` to completion; returns ``uid ->``
        :class:`Completion`.  Re-entrant: call again with more requests —
        the cache, pools and step functions are reused."""
        queue = collections.deque(requests)
        while queue or self._meta:
            self._admit(queue)
            if not self._meta:
                if queue:
                    raise CacheOutOfPages(
                        "no slot can ever admit the next request "
                        f"(prompt+budget needs more pages than the "
                        f"pool holds: {queue[0].uid!r})")
                break
            self._decode_window()
        return self.completions
