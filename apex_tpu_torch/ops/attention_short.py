"""Short-sequence attention (fmha-short) forward: a CUDA kernel and its
plain version.

Replaces ``apex_tpu/ops/attention_short.py::_short_fwd_kernel``.  The
kernel (``csrc/attention_short.cu``) notes its design: one block per
(batch*head, 64-row query tile), an online softmax over 64-key K/V tiles
(the whole-sequence pass of the TPU kernel does not fit 227 KB of shared
memory at s = 512, d = 128), WMMA tensor-core products in bf16 and full
fp32 products for fp32.  It returns ``out`` in the input dtype and the
row logsumexp ``lse`` (fp32) that the backward of a later slice replays.

Not ported yet (ROADMAP.md queue B item 2): additive bias, segment ids
and dropout; the backward is queue B item 7.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops.common import (
    check, check_operands, count_launch, load, stream_of,
)

__all__ = ["fmha_short", "short_fwd", "FMHA_SHORT_MAX_SEQ"]

KERNEL = "short_fwd"

#: The longest sequence the short kernel is built and tested for.  512 is
#: the JAX package's window; it is NOT a crossover measured on the H100
#: (there is no mid or flash rung in the port yet to cross over to).
FMHA_SHORT_MAX_SEQ = 512

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _short_fwd_plain(q, k, v, causal, scale):
    """The plain PyTorch version, mirroring the TPU kernel's arithmetic:
    fp32 scores of the scaled query, finite -1e30 fill, exact softmax
    with masked probabilities zeroed, ``l`` clamped at 1e-30."""
    sq, sk = q.shape[-2], k.shape[-2]
    qf = q.float() * scale
    s = torch.matmul(qf, k.float().transpose(-1, -2))
    mask = None
    if causal:
        q_idx = torch.arange(sq, device=q.device)[:, None]
        k_idx = torch.arange(sk, device=q.device)[None, :]
        mask = k_idx <= q_idx
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v.float())
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


@functools.lru_cache(maxsize=None)
def _entry():
    """The loaded library and its C entry, typed once."""
    lib = load("attention_short")
    fn = lib.short_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _short_fwd_cuda(q, k, v, causal, scale):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{KERNEL}: q/k/v must share one dtype of "
                         f"{list(_DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head_dim {d} not in {_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{KERNEL}: batch*heads {b * h} > 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_operands(KERNEL, q, k, v)
    lib, fn = _entry()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    count_launch(KERNEL)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b * h, sq, sk, d, _DTYPES[q.dtype],
             int(causal), float(scale), stream_of(q))
    check(lib, KERNEL, err)
    return out, lse


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
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{KERNEL}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (b, h, s, d) alike")
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    if max(sq, sk) > FMHA_SHORT_MAX_SEQ:
        raise ValueError(f"{KERNEL}: sequence {max(sq, sk)} > "
                         f"FMHA_SHORT_MAX_SEQ={FMHA_SHORT_MAX_SEQ}")
    scale = (1.0 / d ** 0.5) if sm_scale is None else float(sm_scale)
    if q.is_cuda:
        return _short_fwd_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return _short_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f"{KERNEL}: unsupported device {q.device}")


def fmha_short(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-pass short-sequence attention over ``(b, h, s, d)``
    (forward only).  Most callers go through
    :func:`apex_tpu_torch.ops.attention.flash_attention`."""
    out, _ = short_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
    return out
