"""On-device token sampling and speculative acceptance.

Counterpart of ``apex_tpu/serving/sampling.py``.  The sampled ids stay on
the device and feed the next decode step directly; they reach the host
only at the serving driver's harvest.  ``temperature=0`` is greedy:
argmax with the FIRST maximum on ties, as ``jnp.argmax`` does.  Above it
the chain is JAX's: the logits scaled by ``1/T`` in fp32, floored by
top-k, then by top-p on the floored row (a value equal to a threshold
survives), and drawn by Gumbel-max with ``jax.random.gumbel``'s noise, so
a key gives JAX's token.  The floors are plain PyTorch (XLA in JAX:
``topk``, ``sort``, ``softmax``, ``cumsum``) and come down to ONE
threshold a row; the draw is the Triton kernel of ``ops/sampling.py``
(:func:`~apex_tpu_torch.ops.sampling.gumbel_argmax`), which also folds a
slot's key with its context length on the device.

Keys: :func:`sample` takes a host key of :mod:`apex_tpu_torch.random`
and draws the whole ``(..., V)`` block under it, as JAX does;
:func:`spec_accept` and :func:`spec_accept_tree` take per-row keys
``(..., R, 2)`` (int64 words), JAX's per-row keys, or, with ``ctx``, the
slot keys unfolded and the rows' context lengths, which the kernel folds
(what the serving steps pass).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.ops.sampling import NEG_INF, _scaled, gumbel_argmax
from apex_tpu_torch.random import keys_tensor

__all__ = ["greedy", "sample", "sample_rows", "spec_accept",
           "spec_accept_tree"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis, int32, first maximum on ties."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _top_k_threshold(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest logit of each row, ``(..., 1)``."""
    return torch.topk(logits, k, dim=-1).values[..., -1:]


def _top_k_floor(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit of each row to
    ``-1e30``; ties at the threshold all survive."""
    return torch.where(logits >= _top_k_threshold(logits, k), logits,
                       NEG_INF)


def _top_p_threshold(logits: torch.Tensor, p: float) -> torch.Tensor:
    """The nucleus threshold ``(..., 1)``: the least logit of the
    shortest prefix of the descending order whose mass reaches ``p`` (the
    crossing token included, so the argmax always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    return torch.where(keep, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True).to(logits.dtype)


def _top_p_floor(logits: torch.Tensor, p: float) -> torch.Tensor:
    """JAX's nucleus floor: values below the threshold become -1e30."""
    return torch.where(logits >= _top_p_threshold(logits, p), logits,
                       NEG_INF)


def _check_options(temperature, top_k, top_p) -> None:
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _floor(x: torch.Tensor, temperature: float, top_k, top_p):
    """Each row's threshold ``(R,)`` on the scaled logits ``x / T``, or
    None when neither floor applies: the top-k value, then the top-p
    threshold of the top-k-floored row; an entry survives both floors
    iff it is at least the larger of the two."""
    use_k = top_k is not None and top_k < x.shape[-1]
    use_p = top_p is not None and top_p < 1.0
    if not (use_k or use_p):
        return None
    y = _scaled(x, temperature)
    floor = None
    if use_k:
        kth = _top_k_threshold(y, int(top_k))
        y = torch.where(y >= kth, y, NEG_INF)
        floor = kth[:, 0]
    if use_p:
        thresh = _top_p_threshold(y, float(top_p))[:, 0]
        floor = thresh if floor is None else torch.maximum(floor, thresh)
    return floor


def sample_rows(logits: torch.Tensor, keys: torch.Tensor,
                ctx: Optional[torch.Tensor], temperature: float,
                top_k: Optional[int] = None, top_p: Optional[float] = None,
                row_stride: int = 0) -> torch.Tensor:
    """One token a row of ``logits (R, V)`` at ``temperature > 0``, row
    ``r`` drawn under ``keys[r]`` (int64 words) folded with ``ctx[r]``
    when ``ctx`` is given: the serving steps' draw."""
    x = logits.float()
    floor = _floor(x, temperature, top_k, top_p)
    if ctx is not None:
        ctx = ctx.to(torch.int32)
    return gumbel_argmax(x, keys, ctx, temperature, floor, row_stride)


def sample(
    logits: torch.Tensor,
    key=None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """One token id per row of ``logits (..., vocab)``, int32, on the
    logits' device.

    ``temperature=0`` (the default) is greedy and ignores
    ``key``/``top_k``/``top_p``.  Otherwise the logits are scaled by
    ``1/temperature``, floored by ``top_k`` and/or ``top_p`` and drawn by
    Gumbel-max under ``key`` (a host key of :mod:`apex_tpu_torch.random`)
    over the whole ``(..., vocab)`` block, numbered as
    ``jax.random.gumbel(key, logits.shape)`` numbers it."""
    _check_options(temperature, top_k, top_p)
    if temperature == 0.0:
        return greedy(logits)
    if key is None:
        raise ValueError("temperature > 0 requires a PRNG key")
    lead, vocab = tuple(logits.shape[:-1]), logits.shape[-1]
    x = logits.reshape(-1, vocab)
    keys = keys_tensor(np.asarray(key, dtype=np.uint32),
                       logits.device).expand(x.shape[0], 2).contiguous()
    return sample_rows(x, keys, None, temperature, top_k, top_p,
                       row_stride=vocab).reshape(lead)


def _targets(logits, keys, ctx, temperature, top_k, top_p, what: str):
    """Each row's draw: the argmax at ``temperature=0``, else one draw a
    row under its key (``keys (..., R, 2)``, folded with ``ctx (..., R)``
    when given)."""
    _check_options(temperature, top_k, top_p)
    if temperature == 0.0:
        return greedy(logits)
    if keys is None:
        raise ValueError(f"temperature > 0 requires per-{what} PRNG keys")
    lead, vocab = tuple(logits.shape[:-1]), logits.shape[-1]
    keys = torch.as_tensor(keys, device=logits.device).to(torch.int64)
    keys = keys.expand(lead + (2,)).reshape(-1, 2)
    if ctx is not None:
        ctx = ctx.expand(lead).reshape(-1)
    return sample_rows(logits.reshape(-1, vocab), keys, ctx, temperature,
                       top_k, top_p).reshape(lead)


def spec_accept(
    logits: torch.Tensor,
    drafts: torch.Tensor,
    draft_len: torch.Tensor,
    keys=None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    *,
    ctx: Optional[torch.Tensor] = None,
):
    """Speculative accept/commit for a chain verify step.

    ``logits (..., R, vocab)`` are the verify step's R = k+1 rows (row j
    predicts the token after j committed drafts), ``drafts (..., R-1)``
    the proposed tokens and ``draft_len (...)`` how many are real (the
    JAX function is one slot, no leading dims; here any leading dims are
    slots).  Returns ``(targets (..., R) int32, n_accept (...) int32)``:
    each row's draw and the length of the accepted draft prefix; the
    caller commits ``targets[..., :n_accept + 1]``.  At ``temperature >
    0`` row j draws under ``keys[..., j, :]``, the slot key folded with
    the row's absolute context length (or, with ``ctx``, the slot key
    that the kernel folds with ``ctx[..., j]``): the plain one-token
    sampler's key for that position, so the committed stream is the
    plain sampled stream, token for token."""
    if logits.ndim < 2:
        raise ValueError(
            f"logits must be (rows, vocab), got {tuple(logits.shape)}")
    rows = logits.shape[-2]
    if tuple(drafts.shape) != tuple(logits.shape[:-2]) + (rows - 1,):
        raise ValueError(
            f"drafts must be ({rows - 1},) for {rows} logit rows, got "
            f"{tuple(drafts.shape)}")
    targets = _targets(logits, keys, ctx, temperature, top_k, top_p, "row")
    j = torch.arange(rows - 1, device=logits.device)
    match = (drafts.to(torch.int32) == targets[..., :-1]) & (
        j < torch.as_tensor(draft_len, device=logits.device)[..., None])
    # longest accepted PREFIX: one mismatch rejects everything after it
    n_accept = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
    return targets, n_accept.to(torch.int32)


def spec_accept_tree(
    logits: torch.Tensor,
    drafts: torch.Tensor,
    parents: tuple,
    valid: torch.Tensor,
    keys=None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    *,
    ctx: Optional[torch.Tensor] = None,
):
    """Accept/commit over a candidate TREE for a verify step.

    ``logits (..., R, vocab)`` are the rows of R tree nodes in
    topological order (node 0 the root, node ``r >= 1`` carries
    ``drafts[..., r-1]`` and hangs off the STATIC ``parents[r] < r``);
    ``valid (..., R-1)`` masks the real draft nodes.  Each node draws ONE
    target (its argmax at ``temperature=0``; else under ``keys[..., r,
    :]``, keyed by the node's DEPTH, or folded with ``ctx[..., r]`` in the
    kernel), and the root-to-leaf walk accepts, at each depth, the first
    valid child whose draft equals its parent's target.  Returns ``(out
    (..., R), n_accept (...), path (..., R))``, int32: ``out[t]`` is the
    token committed at new position ``t``, ``n_accept`` the depth of the
    deepest accepted node, ``path[t]`` the row of the committed node at
    depth ``t``.  A chain-shaped ``parents`` reduces to
    :func:`spec_accept`."""
    if logits.ndim < 2:
        raise ValueError(
            f"logits must be (rows, vocab), got {tuple(logits.shape)}")
    rows = logits.shape[-2]
    lead = tuple(logits.shape[:-2])
    parents = tuple(int(p) for p in parents)
    if len(parents) != rows:
        raise ValueError(
            f"parents must have {rows} entries (one per logit row), got "
            f"{len(parents)}")
    if parents[0] != -1:
        raise ValueError(f"parents[0] must be -1 (root), got {parents[0]}")
    for r in range(1, rows):
        if not 0 <= parents[r] < r:
            raise ValueError(
                f"parents[{r}] = {parents[r]} must be in [0, {r}) — "
                "topological order")
    if tuple(drafts.shape) != lead + (rows - 1,):
        raise ValueError(
            f"drafts must be ({rows - 1},) for {rows} logit rows, got "
            f"{tuple(drafts.shape)}")
    if tuple(valid.shape) != lead + (rows - 1,):
        raise ValueError(
            f"valid must be ({rows - 1},), got {tuple(valid.shape)}")
    depth = [0] * rows
    for r in range(1, rows):
        depth[r] = depth[parents[r]] + 1
    targets = _targets(logits, keys, ctx, temperature, top_k, top_p,
                       "node").long()
    drafts = drafts.long()
    ok = torch.cat([torch.ones(lead + (1,), dtype=torch.bool,
                               device=logits.device),
                    valid.to(torch.bool)], dim=-1)
    cur = torch.zeros(lead, dtype=torch.long, device=logits.device)
    n_acc = torch.zeros(lead, dtype=torch.int32, device=logits.device)
    out_rows, path_rows = [], []
    # the walk, unrolled per depth level: at the current path node, the
    # first valid child whose draft equals the node's target extends the
    # path; no match ends it (level t+1 hangs off depth-t nodes only)
    for t in range(rows):
        tgt_cur = torch.gather(targets, -1, cur[..., None])[..., 0]
        path_rows.append(cur)
        out_rows.append(tgt_cur)
        level = [r for r in range(1, rows) if depth[r] == t + 1]
        if not level:
            continue
        found = torch.zeros(lead, dtype=torch.bool, device=logits.device)
        nxt = cur
        for r in level:
            hit = (~found & ok[..., r] & (cur == parents[r])
                   & (drafts[..., r - 1] == tgt_cur))
            nxt = torch.where(hit, torch.full_like(nxt, r), nxt)
            found = found | hit
        n_acc = n_acc + found.to(torch.int32)
        cur = torch.where(found, nxt, cur)
    return (torch.stack(out_rows, dim=-1).to(torch.int32), n_acc,
            torch.stack(path_rows, dim=-1).to(torch.int32))
