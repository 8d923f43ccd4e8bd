"""Fused scale + mask + softmax: a Triton forward kernel, its plain
version, and the backward.

Replaces ``apex_tpu/ops/softmax.py::_softmax_fwd_kernel`` (the Pallas TPU
kernel behind ``scaled_softmax`` and ``scaled_upper_triang_masked_softmax``).
Semantics, as in the JAX package: ``softmax(scale * x)`` over the last
dim with fp32 statistics whatever the input dtype, the output in x's
dtype; the fill is -10000 (not -inf, so a fully masked row is uniform),
applied after the scale, at keys past the query (``causal``) and wherever
the boolean ``mask`` is True; causal and mask compose.

The masked variant has no Pallas kernel in JAX (it runs in XLA there).
Here the kernel takes the mask as an optional operand, so every call on a
CUDA tensor launches the kernel and no plain path runs on the card.  The
mask comes broadcast, ``(b|1, np|1, sq, sk)`` against x's ``(b, np, sq,
sk)``, and the kernel reads it through its strides (a broadcast dim has
stride 0): it is never materialised at x's size.

The backward is plain PyTorch, ``dx = scale * y * (dy - sum(dy * y))`` in
fp32, as the JAX package computes it in XLA: it has no TPU kernel to port.

Kernel design (Hopper): one Triton program per row of ``sk`` scores.  The
row is read once into registers (sk up to a few thousand fits one
block), scaled, filled, reduced to its max and sum and written once: the
work is a few operations per byte, so the kernel is bound by the bytes of
x in and y out (and the mask's, where it is not broadcast).  A filled
score is never read: the causal triangle above the diagonal, and the
keys the mask covers, are left out of x's load (a causal row reads
``qi + 1`` scores, so the kernel reads about half of a square x).  No single
PyTorch call applies the scale, the -10000 fill and the softmax in one
pass; ``chip_smoke.py`` times ``torch.softmax`` on the pre-scaled input
beside it as the library yardstick.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from apex_tpu_torch.ops.common import (
    check_implementation,
    count_launch,
    kernel_entry,
)

__all__ = [
    "scaled_softmax",
    "scaled_masked_softmax",
    "scaled_upper_triang_masked_softmax",
]

KERNEL = "softmax_fwd"

_MASK_FILL = -10000.0

#: ``triton.language``, bound by :func:`_softmax_kernel` on first launch so
#: the module imports without Triton (the CPU tests import it).
tl = None


@functools.lru_cache(maxsize=None)
def _softmax_kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def softmax_fwd(X, Y, M, n_rows_per_b, n_rows_per_h, SQ, SK, scale,
                    m_sb, m_sh, m_sq, m_sk,
                    CAUSAL: tl.constexpr, HAS_MASK: tl.constexpr,
                    BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        inb = cols < SK
        qi = row % SQ
        # keep: the scores that are not filled; a filled score is never read
        keep = inb
        if CAUSAL:
            keep = keep & (cols <= qi)
        if HAS_MASK:
            bi = row // n_rows_per_b
            hi = (row // n_rows_per_h) % (n_rows_per_b // n_rows_per_h)
            mrow = M + bi * m_sb + hi * m_sh + qi * m_sq
            mk = tl.load(mrow + cols * m_sk, mask=keep, other=1)
            keep = keep & (mk == 0)
        x = tl.load(X + row * SK + cols, mask=keep, other=0.0)
        x = tl.where(keep, x.to(tl.float32) * scale, -10000.0)
        x = tl.where(inb, x, float("-inf"))
        x = x - tl.max(x, axis=0)
        ex = tl.exp(x)
        y = ex / tl.sum(ex, axis=0)
        tl.store(Y + row * SK + cols, y.to(Y.dtype.element_ty), mask=inb)

    return triton, softmax_fwd


def _as_4d(x: torch.Tensor) -> torch.Tensor:
    """x's leading dims folded to ``(b, np)``: x itself when 4-D."""
    if x.ndim == 4:
        return x
    sq, sk = x.shape[-2:]
    lead = x.shape[:-2]
    n = 1
    for s in lead:
        n *= int(s)
    return x.reshape(1, n, sq, sk)


def _mask_4d(mask: torch.Tensor, x4: torch.Tensor,
             shape) -> torch.Tensor:
    """The mask broadcast against x, as a 4-D view with x4's dims (a
    broadcast dim keeps stride 0: nothing is copied when x is 4-D)."""
    m = torch.broadcast_to(mask, shape)
    if len(shape) == 4:
        return m
    return m.reshape(x4.shape)


def softmax_cost(x, mask, causal: bool):
    """The ``(operations, bytes)`` of one call, as PERF.md's bound column
    counts it: the scores the softmax must read (a filled score, above
    the diagonal when causal or where the mask is True, is never needed;
    counted from this call's mask), y written once and the mask's bytes;
    five operations a score."""
    sq, sk = x.shape[-2:]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=x.device)
    if causal:
        keep = keep.tril()
    if mask is not None:
        keep = keep & ~mask.to(torch.bool)
    read = int(torch.broadcast_to(keep, x.shape).sum())
    nbytes = (read + x.numel()) * x.element_size() + (
        0 if mask is None else mask.numel())
    return 5.0 * x.numel(), float(nbytes)


def _softmax_fwd_cuda(x, mask, scale, causal):
    triton, kernel = _softmax_kernel()
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"{KERNEL}: unsupported dtype {x.dtype}")
    x4 = _as_4d(x.contiguous())
    b, np_, sq, sk = x4.shape
    y = torch.empty_like(x4)
    if mask is not None:
        if mask.device != x.device:
            raise ValueError(f"{KERNEL}: mask on {mask.device}, x on "
                             f"{x.device}")
        m4 = _mask_4d(mask.to(torch.bool), x4, x.shape).view(torch.uint8)
        strides = tuple(m4.stride())
    else:
        m4, strides = x4, (0, 0, 0, 0)
    rows = b * np_ * sq
    if rows == 0:
        return y.reshape(x.shape)
    block = triton.next_power_of_2(sk)
    num_warps = min(max(block // 256, 1), 16)
    with count_launch(KERNEL):
        kernel[(rows,)](
            x4, y, m4, np_ * sq, sq, sq, sk, float(scale), *strides,
            CAUSAL=bool(causal), HAS_MASK=mask is not None, BLOCK=block,
            num_warps=num_warps)
    return y.reshape(x.shape)


def _softmax_fwd_plain(x, mask, scale, causal):
    """The plain PyTorch version (the JAX package's ``_softmax_fwd_xla``):
    the CPU tests, and the on-card check."""
    xf = x.float() * scale
    if causal:
        sq, sk = x.shape[-2:]
        upper = torch.ones((sq, sk), dtype=torch.bool,
                           device=x.device).triu(1)
        xf = xf.masked_fill(upper, _MASK_FILL)
    if mask is not None:
        xf = torch.where(mask.to(torch.bool), _MASK_FILL, xf)
    xf = xf - xf.amax(dim=-1, keepdim=True)
    ex = torch.exp(xf)
    return (ex / ex.sum(dim=-1, keepdim=True)).to(x.dtype)


def _costs(x, mask, scale, causal):
    """:func:`_softmax_fwd`'s entry costs (:func:`softmax_cost`)."""
    yield KERNEL, softmax_cost(x, mask, causal)


@kernel_entry(_costs)
def _softmax_fwd(x, mask, scale, causal):
    if x.is_cuda:
        return _softmax_fwd_cuda(x, mask, scale, causal)
    if x.device.type == "cpu":
        return _softmax_fwd_plain(x, mask, scale, causal)
    raise ValueError(f"{KERNEL}: unsupported device {x.device}")


class _FusedSoftmax(torch.autograd.Function):
    """The forward is the kernel; the backward ``dx = scale * y * (dy -
    sum(dy * y))`` in fp32, as the JAX package's custom_vjp."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        y = _softmax_fwd(x, mask, scale, causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        yf, dyf = y.float(), dy.float()
        inner = (dyf * yf).sum(dim=-1, keepdim=True)
        dx = (ctx.scale * yf * (dyf - inner)).to(y.dtype)
        return dx, None, None, None


def scaled_softmax(x: torch.Tensor, scale: float = 1.0,
                   implementation: Optional[str] = None) -> torch.Tensor:
    """``softmax(scale * x)`` over the last dim, fp32 statistics.
    ``implementation`` None or ``"pallas"`` (the JAX argument) runs the
    kernel."""
    check_implementation(KERNEL, implementation)
    return _FusedSoftmax.apply(x, None, float(scale), False)


def scaled_masked_softmax(
    x: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float = 1.0,
    causal: bool = False,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """``softmax(scale * x)`` with the -10000 fill where ``mask`` is True
    (``mask`` broadcasts against x, ``(b, 1, sq, sk)`` against ``(b, np,
    sq, sk)`` as in the reference); ``causal=True`` also masks the strict
    upper triangle.  ``implementation`` as for :func:`scaled_softmax`."""
    check_implementation(KERNEL, implementation)
    if mask is None:
        if causal:
            return scaled_upper_triang_masked_softmax(x, scale)
        return scaled_softmax(x, scale)
    torch.broadcast_shapes(mask.shape, x.shape)     # raises if it cannot
    return _FusedSoftmax.apply(x, mask, float(scale), bool(causal))


def scaled_upper_triang_masked_softmax(
    x: torch.Tensor, scale: float = 1.0,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Causal ``softmax(scale * x)``: the strict upper triangle filled;
    ``implementation`` as for :func:`scaled_softmax`."""
    check_implementation(KERNEL, implementation)
    return _FusedSoftmax.apply(x, None, float(scale), True)
