"""The transducer (RNN-T) joint and loss: the counterpart of
``apex_tpu/contrib/transducer``.

- :class:`TransducerJoint`: ``h[b, t, u] = f[b, t] + g[b, u]``, then the
  ReLU and the dropout where asked.  The dropout is JAX's
  ``where(bernoulli(rng, 1 - p, h.shape), h / (1 - p), 0)``, which is
  :func:`apex_tpu_torch.ops.dropout.dropout`: on the card its Triton
  kernel (counted as ``dropout``, ``dropout_f16`` for fp16), so the
  joint's masks are JAX's bit for bit.  JAX's packed output is a CUDA
  memory layout it replaced by masking: ``pack_output=True`` raises, as
  there.
- :func:`transducer_loss`: the RNN-T negative log-likelihood, JAX's
  alpha recursion in log space over the ``(T, U + 1)`` lattice in fp32.
  Each time row's recursion along the labels is the log-space linear
  recurrence ``a[u] = logaddexp(h[u], a[u - 1] + m[u])``, solved as JAX
  solves it, by ``lax.associative_scan``'s odd-even recursion (pairs
  combined, the half-length scan, then the even positions), ported in
  :func:`associative_scan`, so each ``logaddexp`` takes the operands it
  takes in JAX.  Time is a Python loop; the gradient is autograd's.
  JAX's computation is XLA, so no kernel is replaced here.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.dropout import dropout as _dropout

__all__ = ["TransducerJoint", "TransducerLoss", "transducer_loss",
           "associative_scan"]

_NEG = -1e30


class TransducerJoint(nn.Module):
    """``f (B, T, H)`` and ``g (B, U + 1, H)`` joined into ``(B, T, U + 1,
    H)``; ``rng`` (a port PRNG key) seeds the dropout."""

    def __init__(self, pack_output: bool = False, relu: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        if pack_output:
            raise NotImplementedError(
                "packed output is a memory layout of the reference's CUDA "
                "kernels; use the dense (masked) layout")
        self.relu = relu
        self.dropout = dropout

    def forward(self, f: torch.Tensor, g: torch.Tensor,
                f_len: Optional[torch.Tensor] = None,
                g_len: Optional[torch.Tensor] = None,
                rng=None) -> torch.Tensor:
        h = f[:, :, None, :] + g[:, None, :, :]
        if self.relu:
            h = F.relu(h)
        if self.dropout > 0.0 and rng is not None:
            h = _dropout(h, rng, self.dropout)
        return h


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along dim 1 (``a`` as long as
    ``b`` or one longer)."""
    n = b.shape[1]
    pairs = torch.stack([a[:, :n], b], dim=2).flatten(1, 2)
    return pairs if a.shape[1] == n else torch.cat([pairs, a[:, n:]], 1)


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, ...]:
    """The inclusive scan of ``fn`` over dim 1 of the tensors ``elems``
    by ``lax.associative_scan``'s recursion: combine adjacent pairs,
    scan the half-length result, combine it with the even positions,
    and interleave."""
    n = elems[0].shape[1]
    if n < 2:
        return tuple(elems)
    reduced = fn([e[:, 0:n - 1:2] for e in elems],
                 [e[:, 1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = fn(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], 1) for e, r in zip(elems, even)]
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def _combine(x, y):
    """Affine maps ``a -> logaddexp(add, a + mul)`` composed."""
    xa, xm = x
    ya, ym = y
    return torch.logaddexp(ya, xa + ym), xm + ym


def transducer_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    f_len: torch.Tensor,
    y_len: torch.Tensor,
    blank_idx: int = 0,
) -> torch.Tensor:
    """RNN-T negative log-likelihood per example, fp32.

    ``logits (B, T, U + 1, V)``, ``targets (B, U)`` label ids, ``f_len
    (B,)`` valid time steps, ``y_len (B,)`` valid labels."""
    b, t_max, u1, _ = logits.shape
    u_max = u1 - 1
    logp = torch.log_softmax(logits.float(), dim=-1)
    blank = logp[..., blank_idx]  # (B, T, U + 1)
    index = targets.long()[:, None, :, None].expand(b, t_max, u_max, 1)
    emit = torch.gather(logp[:, :, :u_max, :], -1, index)[..., 0]
    upos = torch.arange(u_max, device=logits.device)
    emit = torch.where(upos[None, None, :] < y_len.long()[:, None, None],
                       emit, torch.full((), _NEG, device=logits.device))
    zero = torch.zeros(b, 1, device=logits.device)

    def row_update(horiz, emit_row):
        mul = torch.cat([zero, emit_row], dim=1)  # mul[0]: no left node
        return associative_scan(_combine, (horiz, mul))[0]

    alpha0 = torch.full((b, u1), _NEG, device=logits.device)
    alpha0[:, 0] = 0.0
    alpha = row_update(alpha0, emit[:, 0])  # row t = 0: vertical only
    rows = [alpha]
    for t in range(1, t_max):
        alpha = row_update(alpha + blank[:, t - 1], emit[:, t])
        rows.append(alpha)
    alphas = torch.stack(rows)  # (T, B, U + 1)

    t_idx = torch.clamp(f_len.long() - 1, 0, t_max - 1)
    batch = torch.arange(b, device=logits.device)
    ylen = y_len.long()[:, None]
    a_fin = alphas[t_idx, batch].gather(1, ylen)[:, 0]
    bl_fin = blank[batch, t_idx].gather(1, ylen)[:, 0]
    return -(a_fin + bl_fin)


class TransducerLoss(nn.Module):
    """The module form of :func:`transducer_loss`.  The softmax-backward
    fusion is autograd's here; JAX's packed input is a CUDA memory
    layout: ``packed_input=True`` raises, as there."""

    def __init__(self, fuse_softmax_backward: bool = True,
                 packed_input: bool = False):
        super().__init__()
        if packed_input:
            raise NotImplementedError(
                "packed input is a memory layout of the reference's CUDA "
                "kernels; use the dense (masked) layout")

    def forward(self, x, label, f_len, y_len, blank_idx: int = 0):
        return transducer_loss(x, label, f_len, y_len, blank_idx)
