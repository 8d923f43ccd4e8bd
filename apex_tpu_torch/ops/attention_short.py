"""Short-sequence attention (fmha-short): CUDA kernels for the forward and
the backward, and their plain versions.

Replaces ``apex_tpu/ops/attention_short.py::_short_fwd_kernel`` and
``::_short_bwd_kernel``.  The kernels (``csrc/attention_short.cu`` over
the device code of ``csrc/attention_common.cuh``) note their design: the
forward is one block per (batch*head, 64-row query tile) with an online
softmax over 64-key K/V tiles (the whole-sequence pass of the TPU kernel
does not fit 227 KB of shared memory at s = 512, d = 128); the backward is
a delta pass and separate dK/dV and dQ kernels, deterministic, no atomics.
WMMA tensor-core products in bf16, full fp32 products for fp32.

``fmha_short`` is differentiable through a ``torch.autograd.Function``
that saves ``(q, k, v, out, lse)``, as the JAX custom_vjp does.

Segment ids (the Pallas bodies' ``has_segs``): ``q_segment_ids``/
``kv_segment_ids`` ``(b, sq)``/``(b, sk)`` integers let query i see key j
only where their ids are equal, on top of the causal mask.  The same C
entries take them as two int32 pointers (null without them) and launch
the kernels' segment instances, counted as ``short_fwd_seg`` and
``short_bwd_seg``.  A query row that sees no key gives out 0, and 0 in
every gradient, as the Pallas bodies do.  No padding to a block multiple
is needed, so the JAX wrapper's pad ids have no counterpart.

Dropout (the Pallas bodies' ``has_dropout``): ``dropout_rate`` and a
uint32 ``dropout_seed`` drop the probabilities multiplied into V where
:func:`keep_mask` (a copy of the JAX ``_keep_mask`` counter hash over the
global flattened batch*head index and the absolute query and key
positions) says so, and scale the kept ones by ``float32(1 / (1 -
rate))``; the row sum ``l`` and the lse are taken before dropout.  The
backward replays the mask on ``p`` for dV and on ``dp`` before ``dz = p *
(dp - delta)``.  The C entries take the seed, the keep threshold and the
scale by value and launch the kernels' dropout instances, counted as
``short_fwd_drop``/``short_bwd_drop`` (``..._seg_drop`` with segment
ids).

The additive bias (the Pallas bodies' ``has_bias``): ``bias``
broadcastable from ``(1|b, 1|h, sq, sk)`` is added in fp32 to the scaled
scores before the mask, in the forward and where the backward recomputes
``p``.  :func:`bias_slab` casts it to a contiguous fp32 ``(nb, nh, sq,
sk)`` tensor (``nb``/``nh`` 1 on a broadcast dim, also one broadcast by a
stride of 0) and the C entries take it as a pointer with its batch and head
strides, 0 on a broadcast dim, so a shared or per-batch bias is never
expanded per head; they launch the kernels' bias instances, counted as
``<name>_bias`` (``short_fwd_seg_drop_bias`` beside ids and dropout).

The bias is differentiable, as JAX's (the Pallas bodies' dbias output):
when autograd asks for the gradient of a bias with the default
``bias_requires_grad=True``, the backward launches the dQ kernel's dBias
instance, which stores each pair's ``dz = p * (dp - delta)`` (the
gradient with respect to ``s * scale + bias``, unscaled, fp32) to a
zero-filled ``(b, h, sq, sk)`` tensor; :func:`fold_bias_grad` sums it over
the bias's broadcast dims into the bias's own shape and dtype, as JAX
sums it in XLA.  Counted as ``<name>_dbias`` in place of ``_bias``.  With
``bias_requires_grad=False`` (contrib attention's and T5's constant
masks) the gradient is a hard zero, as JAX's, and the bias instance runs.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.common import (
    as_int32, check, check_implementation, check_operands, count_launch,
    kernel_entry, load, stream_of,
)

__all__ = ["fmha_short", "short_fwd", "short_bwd", "FMHA_SHORT_MAX_SEQ",
           "short_seq_threshold"]

KERNEL = "short_fwd"
KERNEL_BWD = "short_bwd"
#: the launch counters of the segment-id instances (the same C entries)
KERNEL_SEG = "short_fwd_seg"
KERNEL_BWD_SEG = "short_bwd_seg"

#: The longest sequence the short rung takes.  512 is the JAX package's
#: window; it is NOT a crossover measured on the H100 (PERF.md records a
#: first short-vs-mid reading; the constant does not move on it yet).
FMHA_SHORT_MAX_SEQ = 512


def short_seq_threshold() -> int:
    """The ladder's short-rung bound, overridable with
    ``APEX_TPU_FMHA_SHORT_MAX_SEQ`` as in the JAX package (``0`` turns
    the rung off)."""
    v = os.environ.get("APEX_TPU_FMHA_SHORT_MAX_SEQ")
    return int(v) if v else FMHA_SHORT_MAX_SEQ

_NEG_INF = -1e30
#: the kernels' element types (the C entries' dtype codes); each lives in
#: a library of its own (:func:`library`)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128)

#: the dropout arguments every attention C entry takes after ``scale``:
#: the uint32 seed and keep threshold (as ints with their bits) and the
#: fp32 ``1 / (1 - rate)``, 0 without dropout
DROP_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_float]
#: ctypes argument types of the C entries, as ``csrc/attention_short.cu``
#: declares them (the mid entries of ``csrc/attention_mid.cu`` take the
#: same arguments): q, k, v, q_ids, kv_ids, bias, out, lse | bh, heads, sq,
#: sk, d, dtype, causal, bias_stride_b, bias_stride_h | scale | seed,
#: keep_threshold, inv_keep | stream
FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
    ctypes.c_float] + DROP_ARGTYPES + [ctypes.c_void_p]
#: q, k, v, q_ids, kv_ids, bias, out, dout, lse, dlse, delta, dq, dk, dv,
#: dbias | bh, heads, sq, sk, d, dtype, causal, the two bias strides | scale
#: | the dropout three | stream
BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [
    ctypes.c_float] + DROP_ARGTYPES + [ctypes.c_void_p]
ARGTYPES = {KERNEL: FWD_ARGTYPES, KERNEL_BWD: BWD_ARGTYPES}


def causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """``(sq, sk)`` True where key ``j`` may be seen by query ``i``
    (``j <= i``, top-left aligned as in the JAX kernels)."""
    return (torch.arange(sk, device=device)[None, :]
            <= torch.arange(sq, device=device)[:, None])


def visible(sq: int, sk: int, causal: bool, q_ids=None, kv_ids=None,
            heads: Optional[int] = None, device=None):
    """True where key ``j`` is visible to query ``i``: ``j <= i`` when
    causal, and ``q_ids[b, i] == kv_ids[b, j]`` with segment ids ``(b,
    s)``.  The mask is ``(sq, sk)``, or with ids ``(b, 1, sq, sk)`` over a
    ``(b, h, sq, sk)`` score, or, given ``heads``, ``(b*h, sq, sk)`` over
    the flattened layout.  None when every key is visible."""
    mask = causal_mask(sq, sk, device) if causal else None
    if q_ids is not None:
        if heads is None:
            seg = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
        else:
            qe = q_ids.repeat_interleave(heads, dim=0)
            ke = kv_ids.repeat_interleave(heads, dim=0)
            seg = qe[:, :, None] == ke[:, None, :]
        mask = seg if mask is None else seg & mask
    return mask


def segment_ids(kernel: str, q_ids, kv_ids, b: int, sq: int, sk: int):
    """Check segment ids against a batch of ``b`` rows of ``sq`` queries
    and ``sk`` keys: both or neither, integer, ``(b, sq)`` and ``(b,
    sk)``.  Returns them as given."""
    if (q_ids is None) != (kv_ids is None):
        raise ValueError("segment ids must be given for both q and kv")
    if q_ids is None:
        return None, None
    for name, ids, s in (("q", q_ids, sq), ("kv", kv_ids, sk)):
        if tuple(ids.shape) != (b, s):
            raise ValueError(f"{kernel}: {name}_segment_ids of shape "
                             f"{tuple(ids.shape)}, expected {(b, s)}")
        if ids.is_floating_point() or ids.is_complex() \
                or ids.dtype == torch.bool:
            raise ValueError(f"{kernel}: {name}_segment_ids must be "
                             f"integers, got {ids.dtype}")
    return q_ids, kv_ids


def id_operands(q_ids, kv_ids):
    """The ids as the C entries take them: contiguous int32 (or None)."""
    if q_ids is None:
        return None, None
    return (q_ids.to(torch.int32).contiguous(),
            kv_ids.to(torch.int32).contiguous())


def data_ptr(t: Optional[torch.Tensor]):
    """``t``'s device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------- cost

def visible_pairs(bh: int, sq: int, sk: int, causal: bool, q_ids=None,
                  kv_ids=None) -> int:
    """The (query, key) pairs the mask lets through over ``bh`` (batch *
    heads) rows: what the kernels' products cost, counted from this
    call's segment ids where there are any (a data-dependent count)."""
    if q_ids is None:
        if not causal:
            return bh * sq * sk
        n = min(sq, sk)
        return bh * (n * (n + 1) // 2 + (sq - n) * sk)
    heads = bh // q_ids.shape[0]
    return heads * int(visible(sq, sk, causal, q_ids, kv_ids).sum())


def attention_cost(q, k, causal, ids, slab, *, products: int, q_like: int,
                   k_like: int, rows: int, dbias: bool = False):
    """The ``(operations, bytes)`` of one attention kernel call, as
    PERF.md's bound column counts it: ``products`` products of 2 * d
    operations a visible pair (two forward, five a short/mid backward,
    four for flash dK/dV and three for its dQ); ``q_like`` tensors of
    q's shape and ``k_like`` of k's in q's dtype, ``rows`` fp32 vectors of
    a value a query row (lse, delta, dlse), the int32 ids and the fp32
    bias slab each read once, and with ``dbias`` the fp32 gradient of
    every score written.  ``q`` is ``(..., sq, d)`` with ``bh`` rows."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    bh = q.numel() // (sq * d)
    q_ids, kv_ids = ids
    pairs = visible_pairs(bh, sq, sk, causal, q_ids, kv_ids)
    nbytes = (q_like * q.numel() + k_like * k.numel()) * q.element_size() \
        + rows * bh * sq * 4
    if q_ids is not None:
        nbytes += 4 * (q_ids.numel() + kv_ids.numel())
    if slab is not None:
        nbytes += 4 * slab.numel()
    if dbias:
        nbytes += 4 * bh * sq * sk
    return 2.0 * products * d * pairs, float(nbytes)


def fwd_cost(q, k, causal, ids, slab):
    """A forward's cost: QK^T and PV; reads q, k, v, writes out and the
    lse."""
    return attention_cost(q, k, causal, ids, slab, products=2, q_like=2,
                          k_like=2, rows=1)


def bwd_cost(q, k, causal, ids, slab, dlse: bool, dbias: bool):
    """A short or mid backward's cost: five products a pair; reads q, k,
    v, out, dout and the lse (and dlse), writes dq, dk, dv (and dBias)."""
    return attention_cost(q, k, causal, ids, slab, products=5, q_like=4,
                          k_like=4, rows=1 + int(dlse), dbias=dbias)


def fwd_costs(names):
    """The :func:`~apex_tpu_torch.ops.common.kernel_entry` costs of a
    short or mid forward entry whose launch counters are ``names``."""
    def costs(q, k, v, causal, *, ids, drop, slab, **_):
        yield (counter(names, ids[0] is not None, drop, slab,
                       half=q.dtype == torch.float16),
               fwd_cost(q, k, causal, ids, slab))
    return costs


def bwd_costs(names):
    """The entry costs of a short or mid backward (:func:`fwd_costs`)."""
    def costs(q, k, v, out, dout, lse, dlse, causal, *, ids, drop, slab,
              dbias=False, **_):
        yield (counter(names, ids[0] is not None, drop, slab, dbias,
                       half=q.dtype == torch.float16),
               bwd_cost(q, k, causal, ids, slab, dlse is not None, dbias))
    return costs


# ---------------------------------------------------------------- bias

def bias_slab(kernel: str, bias, b: int, h: int, sq: int, sk: int):
    """The additive bias as the kernels read it, or None: ``bias``
    broadcastable to ``(b, h, sq, sk)`` (fewer dims are leading ones, as
    JAX reshapes them) as a contiguous fp32 ``(nb, nh, sq, sk)`` tensor,
    ``nb`` 1 or ``b`` and ``nh`` 1 or ``h``.  A batch or head dim of size 1,
    or broadcast by a stride of 0 (``expand``), stays 1, so a shared or
    per-batch bias is never expanded per head; the (sq, sk) dims are
    materialised."""
    if bias is None:
        return None
    if bias.ndim < 4:
        bias = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
    want = (b, h, sq, sk)
    if bias.ndim != 4 or not bias.is_floating_point() or any(
            n not in (1, m) for n, m in zip(bias.shape, want)):
        raise ValueError(f"{kernel}: bias of shape {tuple(bias.shape)} and "
                         f"dtype {bias.dtype} is not a float tensor "
                         f"broadcastable to {want}")
    nb = 1 if bias.shape[0] == 1 or bias.stride(0) == 0 else b
    nh = 1 if bias.shape[1] == 1 or bias.stride(1) == 0 else h
    slab = bias[:nb, :nh].expand(nb, nh, sq, sk)
    return slab.to(torch.float32).contiguous()


def bias_operands(kernel: str, slab):
    """The C entries' bias arguments for a :func:`bias_slab` tensor: its
    pointer (None: no bias), the element stride between batch rows' slabs
    and between heads' slabs (0 on a broadcast dim).  The strides are C
    ints, so the slab must have fewer than 2**31 elements."""
    if slab is None:
        return None, 0, 0
    nb, nh, sq, sk = slab.shape
    if slab.numel() >= 1 << 31:
        raise ValueError(f"{kernel}: bias of {slab.numel()} elements; the "
                         "kernels index it with 32-bit strides")
    return (slab.data_ptr(), nh * sq * sk if nb > 1 else 0,
            sq * sk if nh > 1 else 0)


def fold_bias_grad(g: torch.Tensor, shape, dtype) -> torch.Tensor:
    """The bias's gradient from the kernels' ``g``, fp32 ``(b, h, sq, sk)``
    (the gradient of every pair's biased score): summed over the dims a
    bias of ``shape`` broadcasts (fewer dims are leading ones; a dim of
    size 1 where ``g``'s is larger, also sq or sk), then reshaped to
    ``shape`` and cast to ``dtype``, as JAX folds it (``jnp.sum``,
    ``.astype(bias.dtype)``).  A per-head fp32 bias gets ``g`` itself.  A
    bias expanded by a stride of 0 gets each element its own sum, as a
    tensor of that shape would."""
    lead = (1,) * (4 - len(shape)) + tuple(shape)
    dims = tuple(i for i, n in enumerate(lead) if n == 1 and g.shape[i] > 1)
    if dims:
        g = g.sum(dims, keepdim=True)
    return g.reshape(shape).to(dtype)


def add_bias(s: torch.Tensor, slab) -> torch.Tensor:
    """``s`` (fp32 scores, ``(b, h, sq, sk)`` or, flattened, ``(b*h, sq,
    sk)``) plus a :func:`bias_slab` tensor, as the kernels add it."""
    if slab is None:
        return s
    if s.ndim == 3:
        nbh = s.shape[0]
        nb, nh = slab.shape[:2]
        heads = nbh // nb if nh == 1 else nh
        return (s.view(nbh // heads, heads, *s.shape[1:]) + slab).view(
            s.shape)
    return s + slab


# ------------------------------------------------------------- dropout

MASK32 = 0xFFFFFFFF
#: elements of one int64 temporary of :func:`keep_rows` (chunked by
#: batch*head rows so the plain mask at s = 4096 stays small)
_KEEP_CHUNK = 1 << 24


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The JAX ``_mix32`` 32-bit finalizer over int64 tensors holding
    uint32 values: every product is cut back to 32 bits (its low bits
    survive int64's wrap-around)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def keep_mask(seed, bh, q_idx, k_idx, threshold: int) -> torch.Tensor:
    """The JAX ``_keep_mask``: True where the probability of query
    ``q_idx`` and key ``k_idx`` of flattened batch*head row ``bh`` is
    kept.  ``bh``/``q_idx``/``k_idx`` broadcast (int tensors, absolute
    indices); ``seed`` and ``threshold`` (:func:`keep_threshold`) are
    uint32 values."""
    bh = torch.as_tensor(bh, dtype=torch.int64)
    h = mix32((int(seed) & MASK32) ^ ((bh * 0x9E3779B1) & MASK32))
    q_idx = q_idx.to(torch.int64, copy=False)
    k_idx = k_idx.to(torch.int64, copy=False)
    r = mix32(((h + ((q_idx * 0x85EBCA6B) & MASK32)) & MASK32)
              ^ ((k_idx * 0xC2B2AE3D) & MASK32))
    return (r >> 8) < int(threshold)


def keep_threshold(dropout_rate: float) -> int:
    """The JAX ``_keep_threshold``: ``keep_prob * 2**24``, rounded."""
    return int(round((1.0 - dropout_rate) * (1 << 24)))


def inv_keep(dropout_rate: float) -> float:
    """``1 / (1 - rate)`` as the kernels multiply by it: the Python double
    rounded to fp32, as the Pallas bodies' weakly typed scalar is."""
    return float(np.float32(1.0 / (1.0 - dropout_rate)))


def dropout_spec(kernel: str, dropout_rate: float, dropout_seed):
    """``None`` without dropout, else ``(rate, seed)`` with the seed as a
    uint32 Python int (from an int, a numpy value or a 0-d tensor, whose
    bits are taken as the JAX ``asarray(seed, uint32)`` does).  A rate
    without a seed raises ``ValueError``, as in JAX."""
    rate = float(dropout_rate)
    if rate == 0.0:
        return None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"{kernel}: dropout_rate {rate} not in [0, 1)")
    if dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if isinstance(dropout_seed, torch.Tensor):
        if dropout_seed.numel() != 1:
            raise ValueError(f"{kernel}: dropout_seed must be a scalar")
        dropout_seed = dropout_seed.item()
    return rate, int(np.asarray(dropout_seed).astype(np.int64)) & MASK32


def drop_operands(drop):
    """The C entries' dropout arguments: ``(seed, keep_threshold,
    inv_keep)`` as int32-typed bits and fp32; ``(0, 0, 0.0)`` (no
    dropout instance) for ``drop`` None."""
    if drop is None:
        return 0, 0, 0.0
    rate, seed = drop
    return as_int32(seed), as_int32(keep_threshold(rate)), inv_keep(rate)


def counter(names, segs: bool, drop, bias=None, dbias: bool = False,
            half: bool = False) -> str:
    """A launch counter: the plain or segment name of ``names``, with
    ``_drop`` for a dropout instance, ``_bias`` for a launch with a bias
    and ``_dbias`` in its place for one that also emits the bias's
    gradient, and ``_f16`` last for an fp16 instance."""
    return (names[segs] + ("" if drop is None else "_drop")
            + ("_dbias" if dbias else "" if bias is None else "_bias")
            + ("_f16" if half else ""))


def library(source: str, dtype: torch.dtype) -> str:
    """The CUDA source whose library holds ``dtype``'s instances: bf16's
    is ``csrc/<source>.cu``, fp32's and fp16's ``<source>_f32.cu`` and
    ``<source>_f16.cu``, each built by its own ``nvcc`` beside the others
    (a third of the instances each, so the build's wall is a third's)."""
    return source + {torch.float32: "_f32", torch.float16: "_f16"}.get(
        dtype, "")


def keep_rows(drop, lead, sq: int, sk: int, device) -> torch.Tensor:
    """The keep mask of every (batch*head) row of an operand whose
    leading dims are ``lead`` (``(b, h)`` or ``(b*h,)``; rows numbered
    row-major, as the kernels' global ``bh``), ``lead + (sq, sk)`` bool.
    Built a chunk of rows at a time, so the int64 hash temporaries stay
    at :data:`_KEEP_CHUNK` elements."""
    rate, seed = drop
    nbh = math.prod(lead)
    thr = keep_threshold(rate)
    q_idx = torch.arange(sq, device=device)[:, None]
    k_idx = torch.arange(sk, device=device)[None, :]
    step = max(1, _KEEP_CHUNK // max(1, sq * sk))
    out = torch.empty((nbh, sq, sk), dtype=torch.bool, device=device)
    for b0 in range(0, nbh, step):
        bh = torch.arange(b0, min(nbh, b0 + step), device=device)
        out[b0:b0 + step] = keep_mask(seed, bh[:, None, None], q_idx, k_idx,
                                      thr)
    return out.reshape(*lead, sq, sk)


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float):
    """``where(keep, x, 0) * float32(1 / (1 - rate))``, as the Pallas
    bodies drop ``p`` and ``dp``."""
    return torch.where(keep, x, 0.0) * inv_keep(rate)


def _short_fwd_plain(q, k, v, causal, scale, q_ids=None, kv_ids=None,
                     drop=None, bias=None):
    """The plain PyTorch version, mirroring the TPU kernel's arithmetic:
    fp32 scores of the scaled query, the :func:`bias_slab` ``bias`` added,
    finite -1e30 fill, exact softmax with masked probabilities zeroed,
    ``l`` clamped at 1e-30 (so a row that sees no key gives 0 and an lse of
    about -1e30; a row the bias alone pushes to -1e30 is visible, a
    uniform mean).  With ``drop = (rate, seed)`` the probabilities
    multiplied into V are dropped and scaled; ``l`` and the lse are
    not."""
    qf = q.float() * scale
    s = add_bias(torch.matmul(qf, k.float().transpose(-1, -2)), bias)
    mask = visible(q.shape[-2], k.shape[-2], causal, q_ids, kv_ids,
                   device=q.device)
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if drop is not None:
        p = apply_keep(p, keep_rows(drop, q.shape[:-2], q.shape[-2],
                                    k.shape[-2], q.device), drop[0])
    acc = torch.matmul(p, v.float())
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _short_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale,
                     q_ids=None, kv_ids=None, drop=None, bias=None,
                     dbias: bool = False):
    """The plain PyTorch version of the fused backward, mirroring the TPU
    kernel's arithmetic: the scores are scaled AFTER the product (the
    forward scales q before it), ``p = exp(s - lse)`` with masked entries
    exactly zero, ``delta = rowsum(dout * out)`` in fp32, ``dz = p * (dp -
    delta + dlse)``.  For bf16 inputs the operands ``p`` and ``dz *
    scale`` are rounded to bf16 before their products, where the TPU's
    default precision (and the kernel's tensor cores) round them.  With
    ``drop`` the forward's mask is replayed: dV takes the dropped and
    scaled ``p``, and ``dp`` is dropped and scaled before ``dz``; the
    ``bias`` is added to the scaled scores as in the forward.  With
    ``dbias`` it also returns ``dz`` (fp32, unscaled, 0 where masked), the
    gradient of every pair's biased score, as the dBias instance stores
    it."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s = add_bias(torch.matmul(qf, kf.transpose(-1, -2)) * scale, bias)
    p = torch.exp(s - lse[..., None])
    mask = visible(q.shape[-2], k.shape[-2], causal, q_ids, kv_ids,
                   device=q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p_v = p
    if drop is not None:
        keep = keep_rows(drop, q.shape[:-2], q.shape[-2], k.shape[-2],
                         q.device)
        p_v, dp = apply_keep(p, keep, drop[0]), apply_keep(dp, keep, drop[0])
    resid = dp - (dof * out.float()).sum(-1, keepdim=True)
    if dlse is not None:
        resid = resid + dlse.float()[..., None]
    dz = p * resid

    def operand(x):
        return x if q.dtype == torch.float32 else x.to(q.dtype).float()

    p_op, z_op = operand(p_v), operand(dz * scale)
    dv = torch.matmul(p_op.transpose(-1, -2), dof)
    dk = torch.matmul(z_op.transpose(-1, -2), qf)
    dq = torch.matmul(z_op, kf)
    grads = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return grads + (dz,) if dbias else grads


@functools.lru_cache(maxsize=None)
def _entry(symbol: str, dtype: torch.dtype = torch.bfloat16):
    """The loaded library of ``dtype``'s instances and one of its C
    entries, typed once."""
    lib = load(library("attention_short", dtype))
    fn = getattr(lib, symbol)
    fn.argtypes = ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return lib, fn


def pad_head_dim(q, k, v, sm_scale):
    """A head dim the kernels do not take, below 128, zero-padded to the
    next of :data:`HEAD_DIMS` (as the JAX flash wrapper pads to its 128
    lanes): zero columns change no score, and the caller cuts the padded
    output columns off.  Returns ``(q, k, v, scale)`` with the scale of
    the original head dim."""
    scale = softmax_scale(q, sm_scale)
    d = q.shape[-1]
    if d in HEAD_DIMS or d > HEAD_DIMS[-1]:
        return q, k, v, scale
    pad = min(h for h in HEAD_DIMS if h > d) - d
    return (*(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)),
            scale)


def check_kernel_inputs(kernel: str, q, k, v) -> None:
    """Reject what the attention kernels do not take: a dtype other than
    fp32/bf16/fp16 shared by q/k/v, a head dim other than 64/128, more than
    65535 (batch*heads) rows of the grid.  ``q`` is ``(b, h, s, d)`` or
    the flattened ``(b*h, s, d)``."""
    bh, d = math.prod(q.shape[:-2]), q.shape[-1]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{kernel}: q/k/v must share one dtype of "
                         f"{list(DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {d} not in {HEAD_DIMS}")
    if bh > 65535:
        raise ValueError(f"{kernel}: batch*heads {bh} > 65535")


def check_shapes(kernel: str, q, k, v) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (b, h, s, d) alike")


def launch_fwd(entry, names, q, k, v, causal, scale, q_ids, kv_ids,
               drop=None, bias=None):
    """Launch a short or mid forward C entry (``entry(symbol)`` gives the
    library and the function) over ``(b, h, s, d)``; ``names`` are the
    plain and segment launch counters (:func:`counter` adds ``_drop``
    for ``drop = (rate, seed)`` and ``_bias`` for a :func:`bias_slab`
    ``bias``)."""
    kernel = counter(names, q_ids is not None, drop, bias,
                     half=q.dtype == torch.float16)
    check_kernel_inputs(kernel, q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_ids, kv_ids = id_operands(q_ids, kv_ids)
    check_operands(kernel, q, k, v, *(
        t for t in (q_ids, kv_ids, bias) if t is not None))
    bias_ptr, bias_b, bias_h = bias_operands(kernel, bias)
    lib, fn = entry(names[0], q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with count_launch(kernel):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), data_ptr(q_ids),
                 data_ptr(kv_ids), bias_ptr, out.data_ptr(), lse.data_ptr(),
                 b * h, h, sq, sk, d, DTYPES[q.dtype], int(causal), bias_b,
                 bias_h, float(scale), *drop_operands(drop), stream_of(q))
    check(lib, kernel, err)
    return out, lse


def launch_bwd(entry, names, q, k, v, out, dout, lse, dlse, causal, scale,
               q_ids, kv_ids, drop=None, bias=None, dbias: bool = False):
    """Launch a short or mid backward C entry, as :func:`launch_fwd`.
    With ``dbias`` (and a ``bias``) the dQ kernel's dBias instance runs,
    counted with ``_dbias``, and the gradient of every pair's biased score
    comes back too: ``(dq, dk, dv, g)``, ``g`` fp32 ``(b, h, sq, sk)``,
    zero where a causal tile is skipped."""
    if dbias and bias is None:
        raise ValueError(f"{names[0]}: dBias needs a bias")
    kernel = counter(names, q_ids is not None, drop, bias, dbias,
                     half=q.dtype == torch.float16)
    check_kernel_inputs(kernel, q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    lse = lse.float().contiguous()
    dlse = None if dlse is None else dlse.float().contiguous()
    q_ids, kv_ids = id_operands(q_ids, kv_ids)
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"{kernel}: out/dout {out.dtype}/{dout.dtype} "
                         f"differ from q's {q.dtype}")
    check_operands(kernel, q, k, v, out, dout, lse, *(
        t for t in (dlse, q_ids, kv_ids, bias) if t is not None))
    bias_ptr, bias_b, bias_h = bias_operands(kernel, bias)
    lib, fn = entry(names[0], q.dtype)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    g = (torch.zeros((b, h, sq, sk), dtype=torch.float32, device=q.device)
         if dbias else None)
    with count_launch(kernel):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), data_ptr(q_ids),
                 data_ptr(kv_ids), bias_ptr, out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), data_ptr(dlse), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), data_ptr(g),
                 b * h, h, sq, sk, d, DTYPES[q.dtype], int(causal), bias_b,
                 bias_h, float(scale), *drop_operands(drop), stream_of(q))
    check(lib, kernel, err)
    return (dq, dk, dv, g) if dbias else (dq, dk, dv)


def _check_window(kernel: str, q, k) -> None:
    window = max(FMHA_SHORT_MAX_SEQ, short_seq_threshold())
    if max(q.shape[2], k.shape[2]) > window:
        raise ValueError(f"{kernel}: sequence {max(q.shape[2], k.shape[2])}"
                         f" > the short window {window}")


def softmax_scale(q, sm_scale) -> float:
    """``sm_scale``, or ``1/sqrt(head_dim)`` when it is None."""
    return (1.0 / q.shape[-1] ** 0.5) if sm_scale is None else float(sm_scale)


def short_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of softmax attention over ``(b, h, s, d)`` with
    ``sq, sk <= FMHA_SHORT_MAX_SEQ``; causal masks ``k_idx > q_idx``,
    segment ids ``(b, sq)``/``(b, sk)`` mask unequal ids,
    ``dropout_rate`` with a uint32 ``dropout_seed`` drops probabilities
    by :func:`keep_mask`, and ``bias`` (broadcastable to ``(b, h, sq,
    sk)``) is added to the scaled scores.  A CUDA tensor runs the kernel,
    a CPU tensor the plain version."""
    return _run_fwd(q, k, v, causal, **_checked(
        KERNEL, q, k, v, sm_scale, q_segment_ids, kv_segment_ids,
        dropout_rate, dropout_seed, bias))


def short_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    dlse: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    bias: Optional[torch.Tensor] = None,
    bias_grad: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` of :func:`short_fwd` given the forward's ``out``
    and ``lse`` and the cotangent ``dout`` (and optionally ``dlse``, the
    lse's), with the forward's mask, dropout and bias; with ``bias_grad``
    ``(dq, dk, dv, dbias)``, ``dbias`` the bias's gradient in its shape
    and dtype (:func:`fold_bias_grad`).  A CUDA tensor runs the kernel, a
    CPU tensor the plain version."""
    if bias_grad and bias is None:
        raise ValueError(f"{KERNEL_BWD}: bias_grad=True needs a bias")
    grads = _run_bwd(q, k, v, out, dout, lse, dlse, causal, dbias=bias_grad,
                     **_checked(KERNEL_BWD, q, k, v, sm_scale, q_segment_ids,
                                kv_segment_ids, dropout_rate, dropout_seed,
                                bias))
    if not bias_grad:
        return grads
    return grads[:3] + (fold_bias_grad(grads[3], bias.shape, bias.dtype),)


def _checked(kernel, q, k, v, sm_scale, q_segment_ids, kv_segment_ids,
             dropout_rate, dropout_seed, bias) -> dict:
    """An entry's operands, checked once: the keywords of
    :func:`_run_fwd` and :func:`_run_bwd` (the scale, the ids, the
    dropout spec and the :func:`bias_slab` tensor)."""
    check_shapes(kernel, q, k, v)
    _check_window(kernel, q, k)
    ids = segment_ids(kernel, q_segment_ids, kv_segment_ids, q.shape[0],
                      q.shape[2], k.shape[2])
    return dict(drop=dropout_spec(kernel, dropout_rate, dropout_seed),
                scale=softmax_scale(q, sm_scale), ids=ids,
                slab=bias_slab(kernel, bias, *q.shape[:3], k.shape[2]))


@kernel_entry(fwd_costs((KERNEL, KERNEL_SEG)))
def _run_fwd(q, k, v, causal, *, scale, ids, drop, slab):
    """:func:`short_fwd` on :func:`_checked` operands: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if q.is_cuda:
        return launch_fwd(_entry, (KERNEL, KERNEL_SEG), q, k, v, causal,
                          scale, *ids, drop, slab)
    if q.device.type == "cpu":
        return _short_fwd_plain(q, k, v, causal, scale, *ids, drop, slab)
    raise ValueError(f"{KERNEL}: unsupported device {q.device}")


@kernel_entry(bwd_costs((KERNEL_BWD, KERNEL_BWD_SEG)))
def _run_bwd(q, k, v, out, dout, lse, dlse, causal, *, scale, ids, drop,
             slab, dbias: bool = False):
    """:func:`short_bwd` on :func:`_checked` operands; with ``dbias`` also
    the fp32 ``(b, h, sq, sk)`` gradient of the biased scores."""
    if q.is_cuda:
        return launch_bwd(_entry, (KERNEL_BWD, KERNEL_BWD_SEG), q, k, v, out,
                          dout, lse, dlse, causal, scale, *ids, drop, slab,
                          dbias)
    if q.device.type == "cpu":
        return _short_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale,
                                *ids, drop, slab, dbias)
    raise ValueError(f"{KERNEL_BWD}: unsupported device {q.device}")


def keep_bias_like(ctx, bias, bias_requires_grad: bool) -> None:
    """Remember the shape, dtype and device of an autograd function's
    ``bias`` input (its last) for :func:`grad_of_bias`, and in ``ctx.dbias``
    whether the backward emits its gradient: autograd asks for it and the
    caller left ``bias_requires_grad`` True."""
    ctx.bias_like = None if bias is None else (bias.shape, bias.dtype,
                                               bias.device)
    ctx.dbias = (bias is not None and bias_requires_grad
                 and ctx.needs_input_grad[-1])


def grad_of_bias(ctx, g):
    """The bias's gradient: None when autograd asks for none; with
    ``ctx.dbias`` ``g``, the kernels' fp32 ``(b, h, sq, sk)`` gradient of
    the biased scores, folded into the bias's shape and dtype
    (:func:`fold_bias_grad`); else (``g`` unread) a hard zero of its shape
    and dtype, as the JAX vjps return under ``bias_requires_grad=False``."""
    if ctx.bias_like is None or not ctx.needs_input_grad[-1]:
        return None
    shape, dtype, device = ctx.bias_like
    if ctx.dbias:
        return fold_bias_grad(g, shape, dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


class _ShortAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` with the fused backward; saves
    ``(q, k, v, out, lse)`` as the JAX ``_short_fwd`` does, the bias as
    the kernels read it (:func:`bias_slab`), and the segment ids and the
    dropout rate and seed.  The bias's gradient comes from the dBias
    instance when autograd asks for it under ``bias_requires_grad``, and
    is a hard zero under ``bias_requires_grad=False``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_ids, kv_ids, rate, seed,
                bias_requires_grad, bias):
        ops = _checked(KERNEL, q, k, v, sm_scale, q_ids, kv_ids, rate, seed,
                       bias)
        out, lse = _run_fwd(q, k, v, causal, **ops)
        ctx.save_for_backward(q, k, v, out, lse, ops.pop("slab"))
        ctx.causal, ctx.ops = causal, ops
        keep_bias_like(ctx, bias, bias_requires_grad)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, slab = ctx.saved_tensors
        grads = _run_bwd(q, k, v, out, dout, lse, None, ctx.causal,
                         **ctx.ops, slab=slab, dbias=ctx.dbias)
        return grads[:3] + (None,) * 7 + (grad_of_bias(ctx, grads[-1]),)


def fmha_short(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    bias_requires_grad: bool = True,
    block_bh: Optional[int] = None,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Short-sequence attention over ``(b, h, s, d)``, differentiable in
    q, k and v, with optional segment ids ``(b, sq)``/``(b, sk)``.  Most
    callers go through :func:`apex_tpu_torch.ops.attention.flash_attention`.

    The JAX signature: ``block_bh`` (how many (batch*head) programs a TPU
    grid step packs) is accepted and not used, the CUDA kernels choose
    their own grid; ``implementation`` None, ``"pallas"`` or ``"short"``
    runs the kernel.  A head dim under 128 other than 64 is zero-padded
    to the next the kernels take (:func:`pad_head_dim`).
    ``dropout_rate`` > 0 needs a uint32 ``dropout_seed`` (``ValueError``
    without one, as in JAX).  ``bias`` (broadcastable from ``(1|b, 1|h,
    sq, sk)``; fewer dims are leading ones) is added to the scaled scores;
    it is differentiable by default (the dBias instance), and its gradient
    is a hard zero with ``bias_requires_grad=False``, as in JAX."""
    check_implementation(KERNEL, implementation, ("pallas", "short"))
    dropout_spec(KERNEL, dropout_rate, dropout_seed)
    d = q.shape[-1]
    q, k, v, scale = pad_head_dim(q, k, v, sm_scale)
    out = _ShortAttention.apply(q, k, v, causal, scale, q_segment_ids,
                                kv_segment_ids, dropout_rate, dropout_seed,
                                bias_requires_grad, bias)
    return out[..., :d]
