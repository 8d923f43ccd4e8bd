"""Mid-sequence attention (fmha-mid): CUDA kernels for the forward and the
backward, and their plain versions.

Replaces ``apex_tpu/ops/attention_mid.py::_mid_fwd_kernel`` and
``::_mid_bwd_kernel``, the rung of the attention ladder for
``FMHA_SHORT_MAX_SEQ < s <= FMHA_MID_MAX_SEQ``, the band the flagship
trains in (s = 1024).  The TPU kernels stream K/V blocks through VMEM over
a sequential grid axis with an online softmax and a causal block skip,
and accumulate dq across that axis in the backward.  On the H100 the
streamed online softmax with a causal tile skip is what the shared
forward of ``csrc/attention_common.cuh`` does, so the mid entries
(``csrc/attention_mid.cu``: ``mid_fwd``, ``mid_bwd``) run that device
code with their own launch counters and checks; the backward is a delta
pass that folds in the lse cotangent, then separate dK/dV and dQ kernels,
deterministic and without atomics.

``fmha_mid(return_lse=True)`` returns ``(out, lse)``, both
differentiable: the lse cotangent enters the backward as ``dz = p * (dp -
delta + dlse)``.  ``_xla_with_lse`` is the plain lse reference, as in the
JAX package.

Segment ids ``(b, sq)``/``(b, sk)`` go to the same C entries, which then
launch the kernels' segment instances (counted as ``mid_fwd_seg`` and
``mid_bwd_seg``); they are what ``contrib.fmha`` sends at 512 < max_s <=
2048.  Dropout (``dropout_rate`` with a uint32 ``dropout_seed``) runs the
kernels' dropout instances with the short rung's counter hash, the same
global (bh, query, key) indexing, so every rung draws the same mask for
a seed (counted as ``mid_fwd_drop``/``mid_bwd_drop``, with ``_seg_drop``
beside segment ids); the flagship trains through them at s = 1024.  The
additive bias goes to the same C entries as the short rung's does (its
:func:`~apex_tpu_torch.ops.attention_short.bias_slab` and strides; counted
with ``_bias`` appended), and is differentiable as the short rung's is:
the dQ kernel's dBias instance stores ``dz = p * (dp - delta + dlse)``
(the lse cotangent reaches it through the delta pass) and the wrapper
folds it into the bias's shape (counted as ``mid_bwd_dbias``, with
``_seg``/``_drop`` before it); ``bias_requires_grad=False`` gives a hard
zero.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.attention_short import (
    BWD_ARGTYPES,
    FWD_ARGTYPES,
    _NEG_INF,
    _short_bwd_plain,
    _short_fwd_plain,
    bias_slab,
    check_shapes,
    dropout_spec,
    fold_bias_grad,
    grad_of_bias,
    keep_bias_like,
    launch_bwd,
    launch_fwd,
    library,
    pad_head_dim,
    segment_ids,
    softmax_scale,
    visible,
)
from apex_tpu_torch.ops.common import check_implementation, load

__all__ = ["fmha_mid", "mid_fwd", "mid_bwd", "FMHA_MID_MAX_SEQ",
           "mid_seq_threshold"]

KERNEL = "mid_fwd"
KERNEL_BWD = "mid_bwd"
#: the launch counters of the segment-id instances (the same C entries)
KERNEL_SEG = "mid_fwd_seg"
KERNEL_BWD_SEG = "mid_bwd_seg"
#: ctypes argument types of the C entries (the short entries')
ARGTYPES = {KERNEL: FWD_ARGTYPES, KERNEL_BWD: BWD_ARGTYPES}

#: The longest sequence the ladder sends to the mid rung.  2048 is the JAX
#: package's window; it is NOT a crossover measured on the H100, where the
#: flash rung ran 1.41-1.58x faster than this one at s = 1024-4096
#: (PERF.md); the constant has not moved on that reading yet.
FMHA_MID_MAX_SEQ = 2048


def mid_seq_threshold() -> int:
    """The mid rung's upper bound, overridable with
    ``APEX_TPU_FMHA_MID_MAX_SEQ`` as in the JAX package (``0`` turns the
    rung off)."""
    v = os.environ.get("APEX_TPU_FMHA_MID_MAX_SEQ")
    return int(v) if v is not None and v != "" else FMHA_MID_MAX_SEQ


def _mid_fwd_plain(q, k, v, causal, scale, q_ids=None, kv_ids=None,
                   drop=None, bias=None):
    """The plain version.  The JAX mid kernel computes the short kernel's
    function (scaled q, the bias added, -1e30 fill, masked p zero, ``l``
    clamped at 1e-30, the same dropout) over streamed blocks, so this is
    the short kernel's plain version."""
    return _short_fwd_plain(q, k, v, causal, scale, q_ids, kv_ids, drop,
                            bias)


def _mid_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale,
                   q_ids=None, kv_ids=None, drop=None, bias=None,
                   dbias=False):
    """The plain backward, the short kernel's with the lse cotangent:
    ``dz = p * (dp - delta + dlse)`` (returned too with ``dbias``)."""
    return _short_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale,
                            q_ids, kv_ids, drop, bias, dbias)


def _xla_with_lse(q, k, v, causal, sm_scale=None, q_segment_ids=None,
                  kv_segment_ids=None, dropout_rate=0.0, dropout_seed=None,
                  bias=None):
    """``mha_reference`` plus the per-row log-sum-exp (taken before
    dropout), from the same masked-score formula the kernels use (the JAX
    package's plain reference for ``return_lse`` callers);
    differentiable by autograd."""
    from apex_tpu_torch.ops.attention import mha_reference

    out = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                        bias=bias, q_segment_ids=q_segment_ids,
                        kv_segment_ids=kv_segment_ids,
                        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * softmax_scale(
        q, sm_scale)
    if bias is not None:
        s = s + bias.float()
    mask = visible(sq, sk, causal, q_segment_ids, kv_segment_ids,
                   device=q.device)
    if mask is None:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out, m[..., 0] + torch.log(l[..., 0])


@functools.lru_cache(maxsize=None)
def _entry(symbol: str, dtype: torch.dtype = torch.bfloat16):
    """The loaded library of ``dtype``'s instances and one of its C
    entries, typed once."""
    lib = load(library("attention_mid", dtype))
    fn = getattr(lib, symbol)
    fn.argtypes = ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return lib, fn


def mid_fwd(
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
    """``(out, lse)`` of softmax attention over ``(b, h, s, d)``, any
    sequence length (the ladder sends it 512 < s <= 2048), with optional
    segment ids ``(b, sq)``/``(b, sk)``, dropout and a bias broadcastable
    to ``(b, h, sq, sk)``.  A CUDA tensor runs the kernel, a CPU tensor
    the plain version."""
    return _run_fwd(q, k, v, causal, **_checked(
        KERNEL, q, k, v, sm_scale, q_segment_ids, kv_segment_ids,
        dropout_rate, dropout_seed, bias))


def mid_bwd(
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
    """``(dq, dk, dv)`` of :func:`mid_fwd` from its ``out``/``lse``, the
    output cotangent ``dout`` and the optional lse cotangent ``dlse``,
    with the forward's mask, dropout and bias; with ``bias_grad``
    ``(dq, dk, dv, dbias)``, the bias's gradient in its shape and dtype.
    A CUDA tensor runs the kernel, a CPU tensor the plain version."""
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
    ids = segment_ids(kernel, q_segment_ids, kv_segment_ids, q.shape[0],
                      q.shape[2], k.shape[2])
    return dict(drop=dropout_spec(kernel, dropout_rate, dropout_seed),
                scale=softmax_scale(q, sm_scale), ids=ids,
                slab=bias_slab(kernel, bias, *q.shape[:3], k.shape[2]))


def _run_fwd(q, k, v, causal, *, scale, ids, drop, slab):
    """:func:`mid_fwd` on :func:`_checked` operands: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if q.is_cuda:
        return launch_fwd(_entry, (KERNEL, KERNEL_SEG), q, k, v, causal,
                          scale, *ids, drop, slab)
    if q.device.type == "cpu":
        return _mid_fwd_plain(q, k, v, causal, scale, *ids, drop, slab)
    raise ValueError(f"{KERNEL}: unsupported device {q.device}")


def _run_bwd(q, k, v, out, dout, lse, dlse, causal, *, scale, ids, drop,
             slab, dbias=False):
    """:func:`mid_bwd` on :func:`_checked` operands; with ``dbias`` also
    the fp32 ``(b, h, sq, sk)`` gradient of the biased scores."""
    if q.is_cuda:
        return launch_bwd(_entry, (KERNEL_BWD, KERNEL_BWD_SEG), q, k, v, out,
                          dout, lse, dlse, causal, scale, *ids, drop, slab,
                          dbias)
    if q.device.type == "cpu":
        return _mid_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale,
                              *ids, drop, slab, dbias)
    raise ValueError(f"{KERNEL_BWD}: unsupported device {q.device}")


class _MidAttention(torch.autograd.Function):
    """``(out, lse) = attention(q, k, v)`` with the fused backward, which
    takes a real lse cotangent; the bias, saved as the kernels read it,
    gets its gradient from the dBias instance under
    ``bias_requires_grad`` and a hard zero otherwise."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_ids, kv_ids, rate, seed,
                bias_requires_grad, bias):
        ops = _checked(KERNEL, q, k, v, sm_scale, q_ids, kv_ids, rate, seed,
                       bias)
        out, lse = _run_fwd(q, k, v, causal, **ops)
        ctx.save_for_backward(q, k, v, out, lse, ops.pop("slab"))
        ctx.causal, ctx.ops = causal, ops
        keep_bias_like(ctx, bias, bias_requires_grad)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, slab = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        grads = _run_bwd(q, k, v, out, dout, lse, dlse, ctx.causal,
                         **ctx.ops, slab=slab, dbias=ctx.dbias)
        return grads[:3] + (None,) * 7 + (grad_of_bias(ctx, grads[-1]),)


def fmha_mid(
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
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    block_bh: Optional[int] = None,
    implementation: Optional[str] = None,
    return_lse: bool = False,
):
    """Mid-sequence attention over ``(b, h, s, d)``, differentiable in q,
    k and v, with optional segment ids ``(b, sq)``/``(b, sk)``.
    ``return_lse=True`` returns ``(out, lse)`` with ``lse`` of shape ``(b,
    h, sq)``, differentiable too.  Most callers go through
    :func:`apex_tpu_torch.ops.attention.flash_attention`.

    The JAX signature: the TPU tiles ``block_q``/``block_k``/``block_bh``
    are accepted and not used (the CUDA kernels choose their own);
    ``implementation`` None, ``"pallas"`` or ``"mid"`` runs the kernel.
    ``dropout_rate`` > 0 needs a uint32 ``dropout_seed`` (``ValueError``
    without one).  ``bias`` (broadcastable from ``(1|b, 1|h, sq, sk)``)
    is added to the scaled scores; it is differentiable by default (the
    dBias instance, through ``out`` and ``lse``), and its gradient is a
    hard zero with ``bias_requires_grad=False``, as in JAX.  A head dim
    the kernels do not take is zero-padded as for
    :func:`~apex_tpu_torch.ops.attention_short.fmha_short`."""
    check_implementation(KERNEL, implementation, ("pallas", "mid"))
    dropout_spec(KERNEL, dropout_rate, dropout_seed)
    d = q.shape[-1]
    q, k, v, scale = pad_head_dim(q, k, v, sm_scale)
    out, lse = _MidAttention.apply(q, k, v, causal, scale, q_segment_ids,
                                   kv_segment_ids, dropout_rate,
                                   dropout_seed, bias_requires_grad, bias)
    out = out[..., :d]
    return (out, lse) if return_lse else out
