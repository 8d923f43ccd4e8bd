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

Not ported yet (ROADMAP.md queue B item 2): additive bias, segment ids
and dropout.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.common import (
    check, check_operands, count_launch, load, stream_of,
)

__all__ = ["fmha_short", "short_fwd", "short_bwd", "FMHA_SHORT_MAX_SEQ",
           "short_seq_threshold"]

KERNEL = "short_fwd"
KERNEL_BWD = "short_bwd"

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
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

#: ctypes argument types of the C entries, as ``csrc/attention_short.cu``
#: declares them (the mid entries of ``csrc/attention_mid.cu`` take the
#: same arguments)
FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]


def causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """``(sq, sk)`` True where key ``j`` may be seen by query ``i``
    (``j <= i``, top-left aligned as in the JAX kernels)."""
    return (torch.arange(sk, device=device)[None, :]
            <= torch.arange(sq, device=device)[:, None])


def _short_fwd_plain(q, k, v, causal, scale):
    """The plain PyTorch version, mirroring the TPU kernel's arithmetic:
    fp32 scores of the scaled query, finite -1e30 fill, exact softmax
    with masked probabilities zeroed, ``l`` clamped at 1e-30."""
    qf = q.float() * scale
    s = torch.matmul(qf, k.float().transpose(-1, -2))
    mask = None
    if causal:
        mask = causal_mask(q.shape[-2], k.shape[-2], q.device)
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v.float())
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _short_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale):
    """The plain PyTorch version of the fused backward, mirroring the TPU
    kernel's arithmetic: the scores are scaled AFTER the product (the
    forward scales q before it), ``p = exp(s - lse)`` with masked entries
    exactly zero, ``delta = rowsum(dout * out)`` in fp32, ``dz = p * (dp -
    delta + dlse)``.  For bf16 inputs the operands ``p`` and ``dz *
    scale`` are rounded to bf16 before their products, where the TPU's
    default precision (and the kernel's tensor cores) round them."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~causal_mask(q.shape[-2], k.shape[-2], q.device),
                          0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    resid = dp - (dof * out.float()).sum(-1, keepdim=True)
    if dlse is not None:
        resid = resid + dlse.float()[..., None]
    dz = p * resid

    def operand(x):
        return x if q.dtype == torch.float32 else x.to(q.dtype).float()

    p_op, z_op = operand(p), operand(dz * scale)
    dv = torch.matmul(p_op.transpose(-1, -2), dof)
    dk = torch.matmul(z_op.transpose(-1, -2), qf)
    dq = torch.matmul(z_op, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The loaded library and one of its C entries, typed once."""
    lib = load("attention_short")
    fn = getattr(lib, symbol)
    fn.argtypes = {"short_fwd": FWD_ARGTYPES,
                   "short_bwd": BWD_ARGTYPES}[symbol]
    fn.restype = ctypes.c_int
    return lib, fn


def check_kernel_inputs(kernel: str, q, k, v) -> None:
    """Reject what the attention kernels do not take: a dtype other than
    fp32/bf16 shared by q/k/v, a head dim other than 64/128, more than
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


def _short_fwd_cuda(q, k, v, causal, scale):
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


def _short_bwd_cuda(q, k, v, out, dout, lse, dlse, causal, scale):
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of softmax attention over ``(b, h, s, d)`` with
    ``sq, sk <= FMHA_SHORT_MAX_SEQ``; causal masks ``k_idx > q_idx``.
    A CUDA tensor runs the kernel, a CPU tensor the plain version."""
    check_shapes(KERNEL, q, k, v)
    _check_window(KERNEL, q, k)
    scale = softmax_scale(q, sm_scale)
    if q.is_cuda:
        return _short_fwd_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return _short_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f"{KERNEL}: unsupported device {q.device}")


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`short_fwd` given the forward's ``out``
    and ``lse`` and the cotangent ``dout`` (and optionally ``dlse``, the
    lse's).  A CUDA tensor runs the kernel, a CPU tensor the plain
    version."""
    check_shapes(KERNEL_BWD, q, k, v)
    _check_window(KERNEL_BWD, q, k)
    scale = softmax_scale(q, sm_scale)
    if q.is_cuda:
        return _short_bwd_cuda(q, k, v, out, dout, lse, dlse, causal, scale)
    if q.device.type == "cpu":
        return _short_bwd_plain(q, k, v, out, dout, lse, dlse, causal, scale)
    raise ValueError(f"{KERNEL_BWD}: unsupported device {q.device}")


class _ShortAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` with the fused backward; saves
    ``(q, k, v, out, lse)`` as the JAX ``_short_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = short_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = short_bwd(q, k, v, out, dout, lse, causal=ctx.causal,
                               sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def fmha_short(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Short-sequence attention over ``(b, h, s, d)``, differentiable in
    q, k and v.  Most callers go through
    :func:`apex_tpu_torch.ops.attention.flash_attention`."""
    return _ShortAttention.apply(q, k, v, causal, sm_scale)
