"""ASP, automatic structured (2:4) sparsity: the counterpart of
``apex_tpu/contrib/sparsity``.

The pattern library, with the port's own copy of JAX's tables:

- ``m4n2_1d``: the best 2 of every 4 along the last dim, the argmax of
  each group's score under the 6 patterns (:func:`mn_1d_best`);
- ``m4n2_2d_best``: the best of the 90 4x4 blocks that are 2:4 along
  rows and columns both (:func:`mn_2d_best`);
- ``m4n2_2d_greedy``: each block's entries in descending magnitude, kept
  unless their row or column holds 2 already (:func:`mn_2d_greedy`).

Masks are argmaxes of pattern scores, so a near-tie picks another
pattern where the scores round otherwise, and the scores are summed
here in a fixed order of exact fp32 additions, never by a product that
could take TF32 on the card: a pattern's score is the sum of its kept
magnitudes gathered and added in the order of their positions.  A 1-D
score is the sum of two magnitudes (JAX's product adds exact zeros to
it), the same in any order, so the 1-D mask is JAX's bit for bit; a 2-D
score sums eight, so the 2-D mask is JAX's except on blocks whose two
best scores lie within that rounding (:func:`near_tie_blocks` finds
them).  The same additions on the card and the CPU give the same mask.
JAX computes all this in XLA, so no kernel is replaced here.

:class:`ASP` is JAX's functional ASP over a state dict (or nested dicts
and lists of tensors): masks computed from the parameters, applied by
``where``, and an optimizer step wrapped to re-apply them; with
``params=`` the wrapper masks the module's tensors in place after a
PyTorch optimizer's ``step()``, as apex's patched step does.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "create_mask",
    "mn_1d_best",
    "mn_2d_best",
    "mn_2d_greedy",
    "near_tie_blocks",
    "ASP",
    "prune_trained_model",
]


# ------------------------------------------------------------- pattern tables
def _valid_1d_patterns(m: int, n: int) -> np.ndarray:
    """Every length-``m`` 0/1 vector with exactly ``n`` ones, in
    ``itertools.combinations`` order."""
    combos = list(itertools.combinations(range(m), n))
    pats = np.zeros((len(combos), m), np.float32)
    for i, keep in enumerate(combos):
        pats[i, list(keep)] = 1.0
    return pats


def _valid_2d_patterns(m: int, n: int) -> np.ndarray:
    """Every ``m x m`` 0/1 block with exactly ``n`` ones a row and at
    most ``n`` a column (for m = 4, n = 2: the 90 doubly 2:4 blocks)."""
    if m > 5:
        raise ValueError(
            f"2d pattern enumeration is C(m,n)^m and impractical for m={m}; "
            "use mn_2d_greedy for larger blocks")
    rows = _valid_1d_patterns(m, n)
    valid = []
    for combo in itertools.product(range(len(rows)), repeat=m):
        block = rows[list(combo)]
        if (block.sum(axis=0) <= n).all():
            valid.append(block)
    return np.stack(valid)  # (P, m, m)


_PATTERN_CACHE: dict = {}


def _patterns_1d(m: int, n: int) -> np.ndarray:
    key = ("1d", m, n)
    if key not in _PATTERN_CACHE:
        _PATTERN_CACHE[key] = _valid_1d_patterns(m, n)
    return _PATTERN_CACHE[key]


def _patterns_2d(m: int, n: int) -> np.ndarray:
    key = ("2d", m, n)
    if key not in _PATTERN_CACHE:
        _PATTERN_CACHE[key] = _valid_2d_patterns(m, n)
    return _PATTERN_CACHE[key]


# ---------------------------------------------------------- mask calculators
def _scores(groups: torch.Tensor, pats: np.ndarray) -> torch.Tensor:
    """``groups (G, K)`` magnitudes scored under ``pats (P, K)`` 0/1
    patterns with the same number of ones: each pattern's kept entries
    gathered and added left to right in fp32, ``(G, P)``."""
    kept = torch.as_tensor(
        np.stack([np.flatnonzero(p) for p in pats]), device=groups.device)
    terms = groups[:, kept]  # (G, P, ones)
    s = terms[..., 0]
    for j in range(1, terms.shape[-1]):
        s = s + terms[..., j]
    return s


def _pattern_table(pats: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(pats, device=device).bool()


def mn_1d_best(w2d: torch.Tensor, m: int = 4, n: int = 2) -> torch.Tensor:
    """Best ``n``-of-``m`` keep mask along the last dim by kept
    magnitude (the first best pattern on a tie, as ``jnp.argmax``)."""
    rows, cols = w2d.shape
    if cols % m:
        raise ValueError(f"{n}:{m} sparsity needs a multiple-of-{m} inner "
                         f"dim, got {cols}")
    pats = _patterns_1d(m, n)
    g = torch.abs(w2d.float()).reshape(-1, m)
    best = torch.argmax(_scores(g, pats), dim=-1)
    return _pattern_table(pats, w2d.device)[best].reshape(rows, cols)


def _blocks(w2d: torch.Tensor, m: int) -> torch.Tensor:
    rows, cols = w2d.shape
    return torch.abs(w2d.float().reshape(rows // m, m, cols // m, m)
                     .permute(0, 2, 1, 3)).reshape(-1, m * m)


def _scores_2d(w2d: torch.Tensor, m: int, n: int) -> torch.Tensor:
    rows, cols = w2d.shape
    if rows % m or cols % m:
        raise ValueError(f"2d {n}:{m} sparsity needs multiple-of-{m} dims, "
                         f"got {tuple(w2d.shape)}")
    pats = _patterns_2d(m, n)
    return _scores(_blocks(w2d, m), pats.reshape(len(pats), -1))


def mn_2d_best(w2d: torch.Tensor, m: int = 4, n: int = 2) -> torch.Tensor:
    """The best ``m x m`` block pattern that keeps the weight ``n:m``
    sparse along rows and columns both."""
    rows, cols = w2d.shape
    scores = _scores_2d(w2d, m, n)
    best = torch.argmax(scores, dim=-1)
    mask = _pattern_table(_patterns_2d(m, n), w2d.device)[best]
    return (mask.reshape(rows // m, cols // m, m, m).permute(0, 2, 1, 3)
            .reshape(rows, cols))


#: two 2-D scores within this many fp32 ulps of the larger are a near
#: tie: another order of a score's eight additions can swap them
NEAR_TIE_ULPS = 8.0


def near_tie_blocks(w2d: torch.Tensor) -> torch.Tensor:
    """The ``(rows / 4, cols / 4)`` blocks of the ``m4n2_2d_best`` mask
    whose two best scores lie within :data:`NEAR_TIE_ULPS` fp32 ulps of
    the best, where another order of the eight additions can pick
    another pattern."""
    rows, cols = w2d.shape
    top = torch.topk(_scores_2d(w2d, 4, 2), 2, dim=-1).values
    gap = top[:, 0] - top[:, 1]
    eps = torch.finfo(torch.float32).eps
    return (gap <= NEAR_TIE_ULPS * eps * top[:, 0]).reshape(rows // 4,
                                                           cols // 4)


def mn_2d_greedy(w2d: torch.Tensor, m: int = 4, n: int = 2) -> torch.Tensor:
    """Greedy doubly ``n:m`` block mask: each block's entries in
    descending magnitude (stable, so ties in position order), kept
    unless their row or column already holds ``n``; all blocks at once,
    the trailing rows and columns that fill no block left dense.  A line
    may keep fewer than ``n``, as in JAX."""
    rows, cols = w2d.shape
    R, C = rows // m, cols // m
    dev = w2d.device
    if R == 0 or C == 0:
        return torch.ones(rows, cols, dtype=torch.bool, device=dev)
    crop = _blocks(w2d[:R * m, :C * m], m)  # (B, m*m)
    order = torch.argsort(-crop, dim=-1, stable=True)
    B = R * C
    keep = torch.zeros(B, m * m, dtype=torch.bool, device=dev)
    rcnt = torch.zeros(B, m, dtype=torch.int32, device=dev)
    ccnt = torch.zeros(B, m, dtype=torch.int32, device=dev)
    b = torch.arange(B, device=dev)
    for idx in order.T:
        r, c = idx // m, idx % m
        ok = (rcnt[b, r] < n) & (ccnt[b, c] < n)
        keep[b, idx] = ok
        rcnt[b, r] += ok.int()
        ccnt[b, c] += ok.int()
    block = (keep.reshape(R, C, m, m).permute(0, 2, 1, 3)
             .reshape(R * m, C * m))
    mask = torch.ones(rows, cols, dtype=torch.bool, device=dev)
    mask[:R * m, :C * m] = block
    return mask


_PATTERNS = {
    "m4n2_1d": lambda w: mn_1d_best(w, 4, 2),
    "m4n2_2d_best": lambda w: mn_2d_best(w, 4, 2),
    "m4n2_2d_greedy": lambda w: mn_2d_greedy(w, 4, 2),
}


def create_mask(w: torch.Tensor, pattern: str = "m4n2_1d") -> torch.Tensor:
    """Boolean keep mask of ``pattern`` for ``w``: 1-3-d tensors have
    their leading dims folded onto rows; a 4-d tensor is an HWIO conv
    kernel, pruned along its input channels (axis 2)."""
    if pattern not in _PATTERNS:
        raise ValueError(f"unknown sparsity pattern {pattern!r}")
    calc = _PATTERNS[pattern]
    shape = w.shape
    if w.dim() <= 3:
        return calc(w.reshape(-1, shape[-1])).reshape(shape)
    if w.dim() == 4:
        h, kw, i, o = shape
        mask = calc(w.permute(0, 1, 3, 2).reshape(h * kw * o, i))
        return mask.reshape(h, kw, o, i).permute(0, 1, 3, 2)
    raise ValueError(f"cannot sparsify a {w.dim()}-d tensor")


# ------------------------------------------------------------------ the tree
def _map(fn: Callable, tree: Any, *rest: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf, *other leaves)`` over nested dicts and lists (a
    state dict is one dict), the structure kept."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest),
                               path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _leaves(tree: Any):
    out = []
    _map(lambda p, x: out.append(x), tree)
    return out


def _default_eligible(path: tuple, leaf: Any) -> bool:
    """2-4-d tensors whose pruned axis (the last; a conv kernel's input
    channels) divides by 4 and whose name (the last part of the path or
    dotted key) says no bias, scale, norm or embedding."""
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
        return False
    pruned_dim = leaf.shape[2] if leaf.dim() == 4 else leaf.shape[-1]
    if leaf.dim() > 4 or pruned_dim % 4:
        return False
    name = str(path[-1]).rsplit(".", 1)[-1].lower() if path else ""
    return not any(t in name for t in ("bias", "scale", "norm", "embed"))


class ASP:
    """Functional ASP::

        asp = ASP()
        masks = asp.compute_sparse_masks(params)
        params = asp.apply_masks(params, masks)
        step = asp.wrap_optimizer_step(opt.step, masks, params=params)

    ``params`` a state dict (``dict(model.named_parameters())``) or
    nested dicts and lists of tensors; masks take its structure, all
    True for an ineligible tensor.  :meth:`extract_pruned` and
    :meth:`restore_dense` keep what a mask removes, JAX's stand-in for
    apex's ``allow_recompute_mask``."""

    def __init__(self, mask_calculator: str = "m4n2_1d",
                 eligible: Optional[Callable[[tuple, Any], bool]] = None):
        self.pattern = mask_calculator
        self.eligible = eligible or _default_eligible

    def compute_sparse_masks(self, params: Any) -> Any:
        def mask(path, leaf):
            if self.eligible(path, leaf):
                return create_mask(leaf.detach(), self.pattern)
            return torch.ones(leaf.shape, dtype=torch.bool,
                              device=leaf.device)

        return _map(mask, params)

    def apply_masks(self, params: Any, masks: Any) -> Any:
        return _map(lambda _, p, m: torch.where(m, p, torch.zeros_like(p)),
                    params, masks)

    @staticmethod
    def apply_masks_(params: Any, masks: Any) -> None:
        """Zero the masked entries of ``params``' tensors in place."""
        with torch.no_grad():
            _map(lambda _, p, m: p.masked_fill_(~m, 0), params, masks)

    def extract_pruned(self, params: Any, masks: Any) -> Any:
        return _map(lambda _, p, m: torch.where(m, torch.zeros_like(p), p),
                    params, masks)

    def restore_dense(self, params: Any, masks: Any, pruned: Any) -> Any:
        return _map(lambda _, p, m, r: torch.where(m, p, r), params, masks,
                    pruned)

    def wrap_optimizer_step(self, step_fn: Callable, masks: Any,
                            params: Any = None) -> Callable:
        """``step_fn`` followed by the masks.  Without ``params`` it is
        JAX's contract: ``step_fn(state, grads, params, ...)`` returns
        ``(new_params, new_state)`` and the new params come back masked.
        With ``params`` (the tensors a PyTorch optimizer updates in
        place) the wrapper calls ``step_fn(*args)``, masks ``params`` in
        place and returns what the step returned."""
        if params is not None:
            def stepped(*a, **kw):
                out = step_fn(*a, **kw)
                self.apply_masks_(params, masks)
                return out

            return stepped

        def wrapped(state, grads, params, *a, **kw):
            new_params, new_state = step_fn(state, grads, params, *a, **kw)
            return self.apply_masks(new_params, masks), new_state

        return wrapped

    @staticmethod
    def sparsity(masks: Any) -> float:
        """Fraction of zeroed weights across all masked tensors."""
        leaves = _leaves(masks)
        zeros = sum(int(m.numel()) - int(m.sum()) for m in leaves)
        total = sum(int(m.numel()) for m in leaves)
        return zeros / max(total, 1)


def prune_trained_model(
    params: Any,
    step_fn: Callable,
    mask_calculator: str = "m4n2_1d",
    eligible: Optional[Callable[[tuple, Any], bool]] = None,
) -> Tuple[Any, Any, Callable]:
    """The pruned params, their masks and the mask-keeping step (JAX's
    functional contract, :meth:`ASP.wrap_optimizer_step` without
    ``params``)."""
    asp = ASP(mask_calculator, eligible)
    masks = asp.compute_sparse_masks(params)
    return (asp.apply_masks(params, masks), masks,
            asp.wrap_optimizer_step(step_fn, masks))
