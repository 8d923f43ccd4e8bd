"""Flash attention, the ladder's rung for long sequences: CUDA kernels for
the forward, dK/dV and dQ, and their plain versions.

Replaces ``apex_tpu/ops/attention.py::_fa_fwd_kernel``,
``::_fa_bwd_dkv_kernel`` and ``::_fa_bwd_dq_kernel``, the kernels behind
the JAX ``_flash`` custom_vjp, which ``flash_attention`` takes for
``max(sq, sk) > mid_seq_threshold()``.  All three work on the flattened
``(b*h, s, d)`` layout of that custom_vjp; ``ops/attention.py`` flattens
and differentiates them.  The kernels (``csrc/attention_flash.cu``) note
their design: the forward streams 64-key K/V tiles past 128-row query
tiles (64 in fp32) with the next tile's copy in flight; the backward is
the FA2 split, one dK/dV kernel per 64-key tile and one dQ kernel per
64-row query tile, deterministic, no atomics, each with its next tile in
flight.

Function, as the TPU kernels compute it: the forward scales q before the
product (rounded to bf16 as the operand for bf16 inputs, where the TPU's
default precision rounds it), fills masked scores with -1e30, zeroes
masked probabilities and clamps ``l`` at 1e-30; the backward replays
``p = exp((q . k) * scale - lse)`` with the scale after the product,
takes ``delta = rowsum(dout * out)`` from outside the kernels (JAX
computes it in XLA) and has no lse cotangent.  Causal masking is top-left
aligned, ``k <= q`` by index, and ``sq != sk`` is allowed.

Segment ids (the Pallas bodies' ``has_segs``): every entry takes
``q_segment_ids``/``kv_segment_ids`` ``(b, sq)``/``(b, sk)`` with
``heads``, the heads a batch row spans in ``b*h``; key j is visible to
query i only where their ids are equal.  The C entries take the ids as two
int32 pointers (null without them) plus ``heads``, and launch the
segment instances, counted as ``flash_fwd_seg``, ``flash_bwd_dkv_seg``
and ``flash_bwd_dq_seg``.  A query row that sees no key gives out 0 and
zero gradients, as the Pallas bodies do.

Dropout (the Pallas bodies' ``has_dropout``): every entry takes
``dropout_rate`` and a uint32 ``dropout_seed``; the forward drops and
scales the probabilities multiplied into V by the short rung's
``keep_mask`` over the global flattened ``bh`` and the absolute query and
key positions (``l`` and the lse undropped), and both backward kernels
replay the mask, on ``p`` for dV and on ``dp`` before ``dz``.  The C
entries take the seed, the keep threshold and the fp32 ``1 / (1 - rate)``
by value; the dropout instances count as ``flash_fwd_drop``,
``flash_bwd_dkv_drop`` and ``flash_bwd_dq_drop`` (``_seg_drop`` beside
segment ids).

The additive bias (the Pallas bodies' ``has_bias``): every entry takes
``bias`` broadcastable to ``(bh / heads, heads, sq, sk)``, turned into the
short rung's :func:`~apex_tpu_torch.ops.attention_short.bias_slab` (fp32,
``(nb, nh, sq, sk)``, never expanded over a broadcast dim) and handed to
the C entries as a pointer with its batch and head strides.  The forward
adds it to its scaled scores, both backward kernels to ``(q . k) *
scale`` before ``p = exp(s - lse)``; launches count with ``_bias``
appended.  The bias is differentiable, as JAX's: the dQ entry's dBias
instance (``flash_bwd_dq(bias_grad=True)``, counted as
``flash_bwd_dq_dbias``) also stores each pair's ``dz = p * (dp - delta)``
in fp32 to a zero-filled ``(bh, sq, sk)`` tensor, which the wrapper folds
into the bias's shape and dtype (the dK/dV kernel is unchanged).

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.attention_short import (
    DROP_ARGTYPES,
    DTYPES,
    FWD_ARGTYPES,
    _NEG_INF,
    add_bias,
    apply_keep,
    bias_operands,
    bias_slab,
    check_kernel_inputs,
    counter,
    data_ptr,
    drop_operands,
    dropout_spec,
    fold_bias_grad,
    id_operands,
    keep_rows,
    library,
    segment_ids,
    softmax_scale,
    visible,
)
from apex_tpu_torch.ops.common import (
    check, check_operands, count_launch, load, stream_of,
)

__all__ = ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_delta"]

KERNEL = "flash_fwd"
KERNEL_DKV = "flash_bwd_dkv"
KERNEL_DQ = "flash_bwd_dq"
#: the launch counters of the segment-id instances (the same C entries)
SEG = {KERNEL: "flash_fwd_seg", KERNEL_DKV: "flash_bwd_dkv_seg",
       KERNEL_DQ: "flash_bwd_dq_seg"}

#: ctypes argument types of the C entries, as ``csrc/attention_flash.cu``
#: declares them: pointers (q, k, v, q_ids, kv_ids, bias, then each
#: entry's own, the dQ entry's ending in dbias), the ints bh, heads, sq,
#: sk, d, dtype, causal and the two
#: bias strides, then scale, the dropout seed, keep threshold and scale,
#: and the stream
ARGTYPES = {
    KERNEL: FWD_ARGTYPES,
    KERNEL_DKV: [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + DROP_ARGTYPES + [ctypes.c_void_p],
    KERNEL_DQ: [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + DROP_ARGTYPES + [ctypes.c_void_p],
}


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (fp32) as a product operand of inputs of ``dtype``: rounded
    to bf16 for bf16 inputs, as the tensor cores and the TPU's default
    precision take it."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _flash_fwd_plain(q, k, v, causal, scale, q_ids=None, kv_ids=None,
                     heads=None, drop=None, bias=None):
    """The plain forward over ``(bh, s, d)``, the kernel's arithmetic:
    ``q * scale`` in fp32 before the product, fp32 scores, the
    :func:`bias_slab` ``bias`` added, -1e30 fill, masked probabilities
    zero, ``l`` (from the fp32 probabilities) clamped at 1e-30, ``p``
    (dropped and scaled with ``drop = (rate, seed)``) rounded to bf16 for
    the bf16 ``p . v``."""
    qs = _operand(q.float() * scale, q.dtype)
    s = add_bias(torch.matmul(qs, k.float().transpose(-1, -2)), bias)
    mask = visible(q.shape[-2], k.shape[-2], causal, q_ids, kv_ids, heads,
                   q.device)
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if drop is not None:
        p = apply_keep(p, keep_rows(drop, q.shape[:1], q.shape[1],
                                    k.shape[1], q.device), drop[0])
    acc = torch.matmul(_operand(p, q.dtype), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dout * out)`` in fp32, ``(bh, sq)``: plain
    PyTorch on either device, as the JAX wrapper computes it in XLA
    between its two backward kernels."""
    return (dout.float() * out.float()).sum(-1)


def _flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale, q_ids=None,
                     kv_ids=None, heads=None, drop=None, bias=None,
                     dbias=False):
    """``(dq, dk, dv)`` with the kernels' arithmetic: ``s = (q . k) *
    scale`` plus the ``bias``, ``p = exp(s - lse)`` with masked entries
    zero, ``dz = p * (dp - delta)``, and for bf16 inputs ``p`` and ``dz *
    scale`` rounded to bf16 as the operands of their products.  With
    ``drop`` the mask is replayed: dV takes the dropped ``p``, ``dp`` is
    dropped before ``dz``.  With ``dbias`` also ``dz`` (fp32 ``(bh, sq,
    sk)``, unscaled), as the dBias instance stores it."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s = add_bias(torch.matmul(qf, kf.transpose(-1, -2)) * scale, bias)
    p = torch.exp(s - lse[..., None])
    mask = visible(q.shape[-2], k.shape[-2], causal, q_ids, kv_ids, heads,
                   q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p_v = p
    if drop is not None:
        keep = keep_rows(drop, q.shape[:1], q.shape[1], k.shape[1], q.device)
        p_v, dp = apply_keep(p, keep, drop[0]), apply_keep(dp, keep, drop[0])
    dz = p * (dp - delta[..., None])
    p_op, z_op = _operand(p_v, q.dtype), _operand(dz * scale, q.dtype)
    dv = torch.matmul(p_op.transpose(-1, -2), dof)
    dk = torch.matmul(z_op.transpose(-1, -2), qf)
    dq = torch.matmul(z_op, kf)
    grads = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return grads + (dz,) if dbias else grads


@functools.lru_cache(maxsize=None)
def _entry(symbol: str, dtype: torch.dtype = torch.bfloat16):
    """The loaded library of ``dtype``'s instances and one of its C
    entries, typed once."""
    lib = load(library("attention_flash", dtype))
    fn = getattr(lib, symbol)
    fn.argtypes = ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_flat(kernel: str, q, k, v, q_ids=None, kv_ids=None,
                heads=None, bias=None):
    """Check the flattened operands, the segment ids of ``bh / heads``
    batch rows and the bias; returns ``(ids, slab)``: the ids as given (or
    Nones) and the bias as :func:`bias_slab` makes it (or None)."""
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (b*h, s, d) alike")
    if q_ids is None and kv_ids is None and bias is None:
        return (None, None), None
    bh = q.shape[0]
    if heads is None or heads <= 0 or bh % heads:
        raise ValueError(f"{kernel}: segment ids and a bias need heads "
                         f"dividing b*h = {bh}, got heads={heads}")
    ids = segment_ids(kernel, q_ids, kv_ids, bh // heads, q.shape[1],
                      k.shape[1])
    return ids, bias_slab(kernel, bias, bh // heads, heads, q.shape[1],
                          k.shape[1])


def _check_cuda(kernel: str, q, k, v, *rest) -> None:
    """Dtype, head dim, grid and alignment checks of a launch (the
    16-byte copies need 16-byte aligned operands)."""
    check_kernel_inputs(kernel, q, k, v)
    for t in rest:
        if t.dtype != q.dtype:
            raise ValueError(f"{kernel}: operand {t.dtype} differs from q's "
                             f"{q.dtype}")
    check_operands(kernel, q, k, v, *rest)
    for t in (q, k, v) + rest:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: operand not 16-byte aligned")


def _launch(kernel, q, k, v, ids, heads, rest, outs, causal, scale,
            drop=None, bias=None, dbias=None):
    """Launch the C entry ``kernel``: pointers q, k, v, the ids, the bias
    (a :func:`bias_slab` tensor or None), then ``rest`` (inputs) and
    ``outs`` (outputs), for the dQ entry ``dbias`` (a zero-filled fp32
    ``(bh, sq, sk)`` tensor, or None), then the sizes, the bias strides
    and the dropout arguments.  Counts the launch under the kernel's name,
    or its segment counter with ids, with ``_drop`` for ``drop = (rate,
    seed)`` and ``_bias`` with a bias (``_dbias`` with ``dbias``)."""
    q_ids, kv_ids = id_operands(*ids)
    check_operands(kernel, q, *(t for t in (q_ids, kv_ids, bias, dbias)
                                if t is not None))
    bias_ptr, bias_b, bias_h = bias_operands(kernel, bias)
    bh, sq, d = q.shape
    lib, fn = _entry(kernel, q.dtype)
    name = counter((kernel, SEG[kernel]), q_ids is not None, drop, bias,
                   dbias is not None, half=q.dtype == torch.float16)
    ptrs = [t.data_ptr() for t in rest + outs]
    if kernel == KERNEL_DQ:
        ptrs.append(data_ptr(dbias))
    count_launch(name)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), data_ptr(q_ids),
             data_ptr(kv_ids), bias_ptr, *ptrs,
             bh, heads or 1, sq, k.shape[1], d, DTYPES[q.dtype], int(causal),
             bias_b, bias_h, float(scale), *drop_operands(drop),
             stream_of(q))
    check(lib, name, err)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, sm_scale: Optional[float] = None,
              q_segment_ids: Optional[torch.Tensor] = None,
              kv_segment_ids: Optional[torch.Tensor] = None,
              heads: Optional[int] = None, dropout_rate: float = 0.0,
              dropout_seed=None, bias: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` over ``q (bh, sq, d)``, ``k, v (bh, sk, d)``:
    ``out`` in q's dtype, ``lse (bh, sq)`` fp32.  Segment ids are ``(bh
    / heads, sq)`` and ``(bh / heads, sk)``; dropout hashes the row of
    ``bh``; ``bias`` is broadcastable to ``(bh / heads, heads, sq,
    sk)``."""
    return run_fwd(q, k, v, causal, **checked(
        KERNEL, q, k, v, sm_scale, q_segment_ids, kv_segment_ids, heads,
        dropout_rate, dropout_seed, bias))


def checked(kernel, q, k, v, sm_scale, q_segment_ids, kv_segment_ids,
            heads, dropout_rate, dropout_seed, bias) -> dict:
    """An entry's operands, checked once: the keywords of :func:`run_fwd`
    and :func:`run_bwd` (the scale, the ids and their ``heads``, the
    dropout spec and the :func:`bias_slab` tensor)."""
    ids, slab = _check_flat(kernel, q, k, v, q_segment_ids, kv_segment_ids,
                            heads, bias)
    return dict(drop=dropout_spec(kernel, dropout_rate, dropout_seed),
                scale=softmax_scale(q, sm_scale), ids=ids, heads=heads,
                slab=slab)


def run_fwd(q, k, v, causal, *, scale, ids, heads, drop, slab):
    """:func:`flash_fwd` on :func:`checked` operands: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, causal, scale, *ids, heads, drop,
                                slab)
    if not q.is_cuda:
        raise ValueError(f"{KERNEL}: unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_cuda(KERNEL, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(KERNEL, q, k, v, ids, heads, (), (out, lse), causal, scale,
            drop, slab)
    return out, lse


def run_bwd(kernel, q, k, v, dout, lse, delta, causal, *, scale, ids, heads,
            drop, slab, dbias=False):
    """:func:`flash_bwd_dkv` (``kernel`` :data:`KERNEL_DKV`: ``(dk, dv)``)
    or :func:`flash_bwd_dq` (:data:`KERNEL_DQ`: ``(dq, g)``, ``g`` with
    ``dbias`` the fp32 gradient of the biased scores viewed as ``(bh /
    heads, heads, sq, sk)``, else None) on :func:`checked` operands."""
    if dbias and (kernel != KERNEL_DQ or slab is None):
        raise ValueError(f"{kernel}: dBias is the dQ entry's, with a bias")
    if q.device.type == "cpu":
        grads = _flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale,
                                 *ids, heads, drop, slab, dbias)
        if kernel == KERNEL_DKV:
            return grads[1:3]
        dq, g = grads[0], grads[3] if dbias else None
    elif q.is_cuda:
        q, k, v, dout, lse, delta = _bwd_operands(kernel, q, k, v, dout, lse,
                                                  delta)
        outs = ((torch.empty_like(k), torch.empty_like(v))
                if kernel == KERNEL_DKV else (torch.empty_like(q),))
        g = (torch.zeros((*q.shape[:2], k.shape[1]), dtype=torch.float32,
                         device=q.device) if dbias else None)
        _launch(kernel, q, k, v, ids, heads, (dout, lse, delta), outs,
                causal, scale, drop, slab, g)
        if kernel == KERNEL_DKV:
            return outs
        dq = outs[0]
    else:
        raise ValueError(f"{kernel}: unsupported device {q.device}")
    return dq, (g.view(-1, heads, *g.shape[1:]) if dbias else None)


def _bwd_operands(kernel, q, k, v, dout, lse, delta):
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    if lse.shape != q.shape[:2] or delta.shape != q.shape[:2] \
            or dout.shape != q.shape:
        raise ValueError(f"{kernel}: dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} do "
                         f"not match q {tuple(q.shape)}")
    _check_cuda(kernel, q, k, v, dout)
    check_operands(kernel, q, lse, delta)
    return q, k, v, dout, lse, delta


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = False, sm_scale: Optional[float] = None,
                  q_segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None,
                  heads: Optional[int] = None, dropout_rate: float = 0.0,
                  dropout_seed=None, bias: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` of :func:`flash_fwd` from its ``lse``, the cotangent
    ``dout`` and ``delta = flash_delta(out, dout)``, with the forward's
    mask, dropout and bias."""
    return run_bwd(KERNEL_DKV, q, k, v, dout, lse, delta, causal, **checked(
        KERNEL_DKV, q, k, v, sm_scale, q_segment_ids, kv_segment_ids, heads,
        dropout_rate, dropout_seed, bias))


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = False, sm_scale: Optional[float] = None,
                 q_segment_ids: Optional[torch.Tensor] = None,
                 kv_segment_ids: Optional[torch.Tensor] = None,
                 heads: Optional[int] = None, dropout_rate: float = 0.0,
                 dropout_seed=None, bias: Optional[torch.Tensor] = None,
                 bias_grad: bool = False):
    """``dq`` of :func:`flash_fwd`, as :func:`flash_bwd_dkv` takes it; with
    ``bias_grad`` ``(dq, dbias)``, the bias's gradient in its shape and
    dtype (the dBias instance, folded as ``_Flash`` folds it)."""
    dq, g = run_bwd(KERNEL_DQ, q, k, v, dout, lse, delta, causal,
                    dbias=bias_grad, **checked(
                        KERNEL_DQ, q, k, v, sm_scale, q_segment_ids,
                        kv_segment_ids, heads, dropout_rate, dropout_seed,
                        bias))
    return (dq, fold_bias_grad(g, bias.shape, bias.dtype)) if bias_grad else dq
