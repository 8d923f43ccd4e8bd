"""Gumbel-max token draws with JAX's noise: a Triton kernel and its plain
version.

The JAX package samples a token inside its jitted serving steps
(``apex_tpu/serving/sampling.py:59-95``): scale the logits by ``1/T``,
floor them by top-k and top-p, add ``jax.random.gumbel(key, x.shape)``
and take the argmax.  That is XLA, not Pallas, so no TPU kernel is
replaced here; XLA fuses the threefry draw, the two logarithms and the
argmax into one pass over the vocabulary.  Plain PyTorch cannot: the hash
alone is some 200 elementwise int64 launches a draw.  So
:func:`gumbel_argmax` on a CUDA tensor launches one Triton kernel that
computes, for each row ``r`` of ``x (R, V)`` fp32 logits:

- its key: ``keys[r]`` (two uint32 words held in int64), folded with
  ``ctx[r]`` (``fold_in``, the slot's context length) when ``ctx`` is
  given;
- the bits of vocabulary index ``i``: ``y0 ^ y1`` of threefry2x32 of the
  counter ``n = r * row_stride + i`` split in two words, as JAX's
  partitionable ``bits`` numbers a ``(R, V)`` draw (``row_stride = V``)
  or a ``(1, V)`` draw a row (``row_stride = 0``);
- ``jax.random.gumbel`` in mode "low" (``jax/_src/random.py``,
  ``_gumbel`` and ``_uniform``): ``f = bitcast((bits >> 9) | 0x3F800000)
  - 1``, ``u = max(tiny, f * float32(1 - tiny) + tiny)`` (the factor is
  1.0 in fp32, so ``u`` is ``f``, or ``tiny`` where ``f`` is 0), ``g =
  -log(-log(u))`` with libdevice's correctly rounded ``logf``;
- ``y = x / T`` (a correctly rounded division), set to ``-1e30`` where
  ``y < floor[r]`` (the top-k / top-p threshold of
  ``serving/sampling.py``);
- ``argmax(y + g)``, the first index among equal maxima.

Bound: each element reads 4 bytes and hashes once (113 integer
operations: 20 rounds of an add, two shifts, an or and a xor, six key
additions of two words, the final xor), so at a decode step's 4 x 32768
the hash, not the bytes, sets the least time.  Four rows give only four
programs a row loop could use, so each row is split over ``split``
programs of ``chunk`` elements; each writes its best (value, index) to a
workspace and the last of a row's programs to arrive (an atomic ticket
on a zeroed counter, reset by that program, as the paged decode kernel
merges its spans) takes the first maximum of the partials in index
order.  One launch a draw, counted as ``gumbel_argmax``.

:func:`_gumbel_argmax_plain` computes the same in plain PyTorch (int64
arithmetic masked to 32 bits): the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from apex_tpu_torch.ops import dropout as _dropout
from apex_tpu_torch.ops.common import (
    check_operands,
    count_launch,
    split_scratch_tensors,
)
from apex_tpu_torch.random import MASK32, fold_in_tensor, threefry2x32_rows

__all__ = ["gumbel_argmax", "gumbel_noise", "gumbel_uniform", "sample_plan",
           "KERNEL", "THREEFRY_OPS"]

KERNEL = "gumbel_argmax"
#: the value a floored logit takes (JAX's ``_NEG_INF``)
NEG_INF = -1e30
#: float32's smallest normal number (``jnp.finfo(float32).tiny``)
TINY = float(np.finfo(np.float32).tiny)
#: 32-bit integer operations of one threefry2x32 hash and the bits' xor
THREEFRY_OPS = 20 * 5 + 6 * 2 + 1
#: elements a program takes a loop step
BLOCK = 1024
#: programs the plan aims at: two a streaming multiprocessor of an H100
TARGET_PROGRAMS = 264


class SamplePlan(NamedTuple):
    """How a draw splits, from its shapes alone: ``split`` programs a row
    (a power of two), ``chunk`` vocabulary entries each (a multiple of
    :data:`BLOCK`)."""

    split: int
    chunk: int


def sample_plan(rows: int, vocab: int) -> SamplePlan:
    """Split each row so that ``rows * split`` is near
    :data:`TARGET_PROGRAMS`, no program taking less than one block."""
    blocks = -(-vocab // BLOCK)
    split = 1
    while split * 2 * rows <= TARGET_PROGRAMS and split * 2 <= blocks:
        split *= 2
    return SamplePlan(split, -(-blocks // split) * BLOCK)


def gumbel_uniform(keys: torch.Tensor, ctx: Optional[torch.Tensor],
                   vocab: int, row_stride: int = 0) -> torch.Tensor:
    """The uniform under :func:`gumbel_noise`: ``jax.random.uniform(k_r,
    minval=tiny, maxval=1)`` at counters ``r * row_stride + i``, with
    ``k_r = fold_in(keys[r], ctx[r])`` (``keys[r]`` when ``ctx`` is
    None), fp32 ``(R, V)``."""
    if ctx is not None:
        keys = fold_in_tensor(keys, ctx)
    R = keys.shape[0]
    n = (torch.arange(vocab, dtype=torch.int64, device=keys.device)[None]
         + torch.arange(R, dtype=torch.int64,
                        device=keys.device)[:, None] * int(row_stride))
    y0, y1 = threefry2x32_rows(keys, n >> 32, n & MASK32)
    bits = y0 ^ y1
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + TINY, TINY)


def gumbel_noise(keys: torch.Tensor, ctx: Optional[torch.Tensor],
                 vocab: int, row_stride: int = 0) -> torch.Tensor:
    """The plain version's ``(R, V)`` fp32 Gumbel noise, ``-log(-log(u))``
    of :func:`gumbel_uniform`: ``jax.random.gumbel`` in mode "low"."""
    return -torch.log(-torch.log(gumbel_uniform(keys, ctx, vocab,
                                                row_stride)))


def _scaled(x: torch.Tensor, temperature: float) -> torch.Tensor:
    """``x / float32(T)`` correctly rounded: the divisor is a tensor on
    ``x``'s device (PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal)."""
    return x / torch.full((), temperature, dtype=torch.float32,
                          device=x.device)


def _gumbel_argmax_plain(x, keys, ctx, temperature, floor, row_stride):
    """The plain version: JAX's noise and argmax, first maximum on ties."""
    y = _scaled(x.float(), temperature)
    if floor is not None:
        y = torch.where(y < floor[:, None], NEG_INF, y)
    g = gumbel_noise(keys, ctx, x.shape[1], row_stride)
    return torch.argmax(y + g, dim=-1).to(torch.int32)


#: ``triton.language``, bound by :func:`_gumbel_kernel` on first launch
#: so the module imports without Triton; ``_threefry2x32`` is
#: ``ops/dropout.py``'s hash, shared, and ``_log`` libdevice's ``logf``
tl = None
_threefry2x32 = None
_log = None


def _libdevice():
    try:
        from triton.language.extra.cuda import libdevice
    except ImportError:
        from triton.language.extra import libdevice
    return libdevice


@functools.lru_cache(maxsize=None)
def _gumbel_kernel():
    global tl, _threefry2x32, _log
    import triton
    import triton.language

    tl = triton.language
    _threefry2x32 = _dropout.threefry_jit()
    _log = _libdevice().log

    @triton.jit(do_not_specialize=["V", "stride_x", "row_stride"])
    def gumbel_kernel(X, KEYS, CTX, FLOOR, PART_V, PART_I, CNT, OUT, V,
                      stride_x, row_stride, temperature,
                      FOLD: tl.constexpr, HAS_FLOOR: tl.constexpr,
                      SPLIT: tl.constexpr, CHUNK: tl.constexpr,
                      BLOCK: tl.constexpr):
        r = tl.program_id(0)
        s = tl.program_id(1)
        a = tl.load(KEYS + 2 * r).to(tl.uint32)
        b = tl.load(KEYS + 2 * r + 1).to(tl.uint32)
        if FOLD:
            c = tl.load(CTX + r).to(tl.uint32)
            a, b = _threefry2x32(a, b, c - c, c)
        if HAS_FLOOR:
            fl = tl.load(FLOOR + r)
        lane = tl.arange(0, BLOCK)
        best_v = tl.full([BLOCK], float("-inf"), tl.float32)
        best_i = tl.zeros([BLOCK], tl.int32)
        row = X + r.to(tl.int64) * stride_x
        base = r.to(tl.int64) * row_stride
        for off in range(0, CHUNK, BLOCK):
            i = s * CHUNK + off + lane
            inb = i < V
            x = tl.load(row + i, mask=inb, other=0.0)
            y = tl.math.div_rn(x, temperature)
            if HAS_FLOOR:
                y = tl.where(y < fl, -1e30, y)
            n = base + i
            y0, y1 = _threefry2x32(a, b, (n >> 32).to(tl.uint32),
                                   (n & 0xFFFFFFFF).to(tl.uint32))
            bits = y0 ^ y1
            f = ((bits >> 9) | 0x3F800000).to(tl.float32, bitcast=True) - 1.0
            u = tl.maximum(f + 1.1754943508222875e-38, 1.1754943508222875e-38)
            z = y - _log(-_log(u))
            z = tl.where(inb, z, float("-inf"))
            # a lane sees its indices in increasing order: strictly
            # greater keeps its first maximum
            take = z > best_v
            best_v = tl.where(take, z, best_v)
            best_i = tl.where(take, i, best_i)
        mv = tl.max(best_v, axis=0)
        mi = tl.min(tl.where(best_v == mv, best_i, 2147483647), axis=0)
        slot = r * SPLIT + s
        tl.store(PART_V + slot, mv)
        tl.store(PART_I + slot, mi)
        tl.debug_barrier()
        ticket = tl.atomic_add(CNT + r, 1, sem="acq_rel", scope="gpu")
        if ticket == SPLIT - 1:
            j = r * SPLIT + tl.arange(0, SPLIT)
            pv = tl.load(PART_V + j, cache_modifier=".cg")
            pi = tl.load(PART_I + j, cache_modifier=".cg")
            top = tl.max(pv, axis=0)
            tl.store(OUT + r, tl.min(tl.where(pv == top, pi, 2147483647),
                                     axis=0))
            tl.store(CNT + r, 0)

    return triton, gumbel_kernel


def _gumbel_argmax_cuda(x, keys, ctx, temperature, floor, row_stride):
    check_operands(KERNEL, *(t for t in (x, keys, ctx, floor)
                             if t is not None))
    if x.dtype != torch.float32 or keys.dtype != torch.int64:
        raise ValueError(f"{KERNEL}: x {x.dtype} / keys {keys.dtype} are "
                         "not float32 / int64")
    for t, dtype in ((ctx, torch.int32), (floor, torch.float32)):
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{KERNEL}: {t.dtype} operand, want {dtype}")
    triton, kernel = _gumbel_kernel()
    R, V = x.shape
    plan = sample_plan(R, V)
    part_v, part_i, cnt = split_scratch_tensors(
        x.device, torch.cuda.current_stream(x.device).cuda_stream,
        2 * R * plan.split, R)
    out = torch.empty((R,), dtype=torch.int32, device=x.device)
    count_launch(KERNEL)
    kernel[(R, plan.split)](
        x, keys, x if ctx is None else ctx, x if floor is None else floor,
        part_v, part_i, cnt, out, V, x.stride(0), int(row_stride),
        float(temperature), FOLD=ctx is not None, HAS_FLOOR=floor is not None,
        SPLIT=plan.split, CHUNK=plan.chunk, BLOCK=BLOCK, num_warps=4)
    return out


def gumbel_argmax(x: torch.Tensor, keys: torch.Tensor,
                  ctx: Optional[torch.Tensor], temperature: float,
                  floor: Optional[torch.Tensor] = None,
                  row_stride: int = 0) -> torch.Tensor:
    """One Gumbel-max draw a row of ``x (R, V)`` fp32 logits:
    ``argmax(where(x / T < floor, -1e30, x / T) + g)`` with ``g`` JAX's
    Gumbel noise under ``fold_in(keys[r], ctx[r])`` (``keys (R, 2)``
    int64 words; ``ctx (R,)`` int32, or None for keys used as given) at
    counters ``r * row_stride + i``.  Returns ``(R,)`` int32.  A CUDA
    tensor launches the kernel, a CPU tensor runs the plain version."""
    if x.ndim != 2 or keys.shape != (x.shape[0], 2):
        raise ValueError(f"{KERNEL}: x {tuple(x.shape)} / keys "
                         f"{tuple(keys.shape)} are not (R, V) / (R, 2)")
    for name, t in (("ctx", ctx), ("floor", floor)):
        if t is not None and t.shape != (x.shape[0],):
            raise ValueError(f"{KERNEL}: {name} {tuple(t.shape)} is not "
                             f"({x.shape[0]},)")
    if not temperature > 0.0:
        raise ValueError(f"{KERNEL}: temperature {temperature} is not > 0")
    if x.is_cuda:
        return _gumbel_argmax_cuda(x, keys, ctx, temperature, floor,
                                   row_stride)
    if x.device.type == "cpu":
        return _gumbel_argmax_plain(x, keys, ctx, temperature, floor,
                                    row_stride)
    raise ValueError(f"{KERNEL}: unsupported device {x.device}")
