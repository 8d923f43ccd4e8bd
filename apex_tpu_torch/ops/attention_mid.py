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

Not ported yet (ROADMAP.md queue B item 2): additive bias, segment ids
and dropout.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.attention_short import (
    BWD_ARGTYPES,
    DTYPES,
    FWD_ARGTYPES,
    _NEG_INF,
    _short_bwd_plain,
    _short_fwd_plain,
    causal_mask,
    check_kernel_inputs,
    check_shapes,
    softmax_scale,
)
from apex_tpu_torch.ops.common import (
    check, check_operands, count_launch, load, stream_of,
)

__all__ = ["fmha_mid", "mid_fwd", "mid_bwd", "FMHA_MID_MAX_SEQ",
           "mid_seq_threshold"]

KERNEL = "mid_fwd"
KERNEL_BWD = "mid_bwd"

#: The longest sequence the ladder sends to the mid rung.  2048 is the JAX
#: package's window; it is NOT a crossover measured on the H100 (the flash
#: rung it would cross over to is not ported yet).
FMHA_MID_MAX_SEQ = 2048


def mid_seq_threshold() -> int:
    """The mid rung's upper bound, overridable with
    ``APEX_TPU_FMHA_MID_MAX_SEQ`` as in the JAX package (``0`` turns the
    rung off)."""
    v = os.environ.get("APEX_TPU_FMHA_MID_MAX_SEQ")
    return int(v) if v is not None and v != "" else FMHA_MID_MAX_SEQ


def _mid_fwd_plain(q, k, v, causal, scale):
    """The plain version.  The JAX mid kernel computes the short kernel's
    function (scaled q, -1e30 fill, masked p zero, ``l`` clamped at
    1e-30) over streamed blocks, so this is the short kernel's plain
    version."""
    return _short_fwd_plain(q, k, v, causal, scale)


def _mid_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale):
    """The plain backward, the short kernel's with the lse cotangent:
    ``dz = p * (dp - delta + dlse)``."""
    return _short_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale)


def _xla_with_lse(q, k, v, causal, sm_scale=None):
    """``mha_reference`` plus the per-row log-sum-exp, from the same
    masked-score formula the kernels use (the JAX package's plain
    reference for ``return_lse`` callers); differentiable by autograd."""
    from apex_tpu_torch.ops.attention import mha_reference

    out = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * softmax_scale(
        q, sm_scale)
    mask = (causal_mask(sq, sk, q.device) if causal
            else torch.ones((sq, sk), dtype=torch.bool, device=q.device))
    s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out, m[..., 0] + torch.log(l[..., 0])


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The loaded library and one of its C entries, typed once."""
    lib = load("attention_mid")
    fn = getattr(lib, symbol)
    fn.argtypes = {"mid_fwd": FWD_ARGTYPES, "mid_bwd": BWD_ARGTYPES}[symbol]
    fn.restype = ctypes.c_int
    return lib, fn


def _mid_fwd_cuda(q, k, v, causal, scale):
    check_kernel_inputs(KERNEL, q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_operands(KERNEL, q, k, v)
    lib, fn = _entry(KERNEL)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    count_launch(KERNEL)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b * h, sq, sk, d, DTYPES[q.dtype],
             int(causal), float(scale), stream_of(q))
    check(lib, KERNEL, err)
    return out, lse


def _mid_bwd_cuda(q, k, v, out, dout, lse, dlse, causal, scale):
    check_kernel_inputs(KERNEL_BWD, q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    lse = lse.float().contiguous()
    extra = [] if dlse is None else [dlse.float().contiguous()]
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"{KERNEL_BWD}: out/dout {out.dtype}/{dout.dtype} "
                         f"differ from q's {q.dtype}")
    check_operands(KERNEL_BWD, q, k, v, out, dout, lse, *extra)
    lib, fn = _entry(KERNEL_BWD)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    count_launch(KERNEL_BWD)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(),
             extra[0].data_ptr() if extra else None, delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, d,
             DTYPES[q.dtype], int(causal), float(scale), stream_of(q))
    check(lib, KERNEL_BWD, err)
    return dq, dk, dv


def mid_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of softmax attention over ``(b, h, s, d)``, any
    sequence length (the ladder sends it 512 < s <= 2048).  A CUDA tensor
    runs the kernel, a CPU tensor the plain version."""
    check_shapes(KERNEL, q, k, v)
    scale = softmax_scale(q, sm_scale)
    if q.is_cuda:
        return _mid_fwd_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return _mid_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f"{KERNEL}: unsupported device {q.device}")


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`mid_fwd` from its ``out``/``lse``, the
    output cotangent ``dout`` and the optional lse cotangent ``dlse``.  A
    CUDA tensor runs the kernel, a CPU tensor the plain version."""
    check_shapes(KERNEL_BWD, q, k, v)
    scale = softmax_scale(q, sm_scale)
    if q.is_cuda:
        return _mid_bwd_cuda(q, k, v, out, dout, lse, dlse, causal, scale)
    if q.device.type == "cpu":
        return _mid_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale)
    raise ValueError(f"{KERNEL_BWD}: unsupported device {q.device}")


class _MidAttention(torch.autograd.Function):
    """``(out, lse) = attention(q, k, v)`` with the fused backward, which
    takes a real lse cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = mid_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = mid_bwd(q, k, v, out, dout, lse, dlse,
                             causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


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
    return_lse: bool = False,
):
    """Mid-sequence attention over ``(b, h, s, d)``, differentiable in q,
    k and v.  ``return_lse=True`` returns ``(out, lse)`` with ``lse`` of
    shape ``(b, h, sq)``, differentiable too.  Most callers go through
    :func:`apex_tpu_torch.ops.attention.flash_attention`."""
    if bias is not None or q_segment_ids is not None \
            or kv_segment_ids is not None or dropout_rate > 0.0:
        raise NotImplementedError(
            "attention bias, segment ids and dropout are not ported yet "
            "(ROADMAP.md queue B item 2)")
    out, lse = _MidAttention.apply(q, k, v, causal, sm_scale)
    return (out, lse) if return_lse else out
