"""On-device token sampling and speculative acceptance, greedy so far.

Counterpart of ``apex_tpu/serving/sampling.py``.  The sampled ids stay on
the device and feed the next decode step directly; they reach the host
only at the serving driver's harvest.  ``temperature=0`` is greedy:
argmax with the FIRST maximum on ties, as ``jnp.argmax`` does.
:func:`spec_accept` and :func:`spec_accept_tree` are the JAX package's
accept rules for a chain and a tree verify at ``temperature=0``: accept
while the draft equals the argmax, then commit the argmax row.
Temperature sampling with top-k / top-p (and the JAX PRNG reproduced
for seeded streams) is ROADMAP.md queue A item 3.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["greedy", "sample", "spec_accept", "spec_accept_tree"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis, int32, first maximum on ties."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(
    logits: torch.Tensor,
    key=None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """One token id per row of ``logits (..., vocab)``, int32, on the
    logits' device.  Only ``temperature == 0`` (greedy, which ignores
    ``key``/``top_k``/``top_p``, as in JAX) is ported; ``key`` is the JAX
    signature's PRNG key, in its second place."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature == 0.0:
        return greedy(logits)
    raise NotImplementedError(
        "temperature > 0 sampling is not ported yet "
        "(ROADMAP.md queue A item 3)")


def _greedy_only(temperature: float) -> None:
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature != 0.0:
        raise NotImplementedError(
            "temperature > 0 speculative acceptance is not ported yet "
            "(ROADMAP.md queue A item 3)")


def spec_accept(
    logits: torch.Tensor,
    drafts: torch.Tensor,
    draft_len: torch.Tensor,
    keys=None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
):
    """Speculative accept/commit for a chain verify step, greedy.

    ``logits (..., R, vocab)`` are the verify step's R = k+1 rows (row j
    predicts the token after j committed drafts), ``drafts (..., R-1)``
    the proposed tokens and ``draft_len (...)`` how many are real (the
    JAX function is one slot, no leading dims; here any leading dims are
    slots).  Returns ``(targets (..., R) int32, n_accept (...) int32)``:
    the per-row argmax and the length of the accepted draft prefix; the
    caller commits ``targets[..., :n_accept + 1]``.  ``keys`` is the JAX
    signature's per-row PRNG keys, unused at ``temperature=0``."""
    _greedy_only(temperature)
    if logits.ndim < 2:
        raise ValueError(
            f"logits must be (rows, vocab), got {tuple(logits.shape)}")
    rows = logits.shape[-2]
    if tuple(drafts.shape) != tuple(logits.shape[:-2]) + (rows - 1,):
        raise ValueError(
            f"drafts must be ({rows - 1},) for {rows} logit rows, got "
            f"{tuple(drafts.shape)}")
    targets = greedy(logits)
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
):
    """Accept/commit over a candidate TREE for a verify step, greedy.

    ``logits (..., R, vocab)`` are the rows of R tree nodes in
    topological order (node 0 the root, node ``r >= 1`` carries
    ``drafts[..., r-1]`` and hangs off the STATIC ``parents[r] < r``);
    ``valid (..., R-1)`` masks the real draft nodes.  The root-to-leaf
    walk accepts, at each depth, the first valid child whose draft equals
    its parent's argmax.  Returns ``(out (..., R), n_accept (...), path
    (..., R))``, int32: ``out[t]`` is the token committed at new position
    ``t``, ``n_accept`` the depth of the deepest accepted node, ``path[t]``
    the row of the committed node at depth ``t``.  A chain-shaped
    ``parents`` reduces to :func:`spec_accept`."""
    _greedy_only(temperature)
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
    targets = greedy(logits).long()
    drafts = drafts.long()
    ok = torch.cat([torch.ones(lead + (1,), dtype=torch.bool,
                               device=logits.device),
                    valid.to(torch.bool)], dim=-1)
    cur = torch.zeros(lead, dtype=torch.long, device=logits.device)
    n_acc = torch.zeros(lead, dtype=torch.int32, device=logits.device)
    out_rows, path_rows = [], []
    # the walk, unrolled per depth level: at the current path node, the
    # first valid child whose draft equals the node's argmax extends the
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
