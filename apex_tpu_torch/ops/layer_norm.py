"""Fused LayerNorm / RMSNorm: a Triton forward kernel, its plain version,
and the backward.

Replaces ``apex_tpu/ops/layer_norm.py::_ln_fwd_kernel`` (the Pallas TPU
kernel behind all five entries: ``fused_layer_norm`` / ``fused_rms_norm``,
their ``_affine`` forms, and ``mixed_dtype_fused_layer_norm_affine``).
The entries without an affine run the kernel with a unit scale and no
shift, which writes the normalized rows rounded to the input dtype, as
JAX's ``_normalize`` returns them; the mixed-dtype entry applies its
affine to those rows in fp32 outside the kernel and casts to the
weight's dtype, as JAX does in XLA.

Contract, as in the JAX package: statistics in fp32 whatever the input
dtype, the normalized rows rounded to the input dtype, the affine applied
in fp32 to those rounded rows, the output in the input dtype, and the
per-row ``mean`` / ``invvar`` (fp32) kept for the backward.

The backward is plain PyTorch, as the JAX package's is plain XLA math
(``_normalize_bwd`` and the transpose of the affine): it has no TPU
kernel to port.  The JAX affine runs outside its custom_vjp, so its
transpose rounds where the forward rounded; :func:`layer_norm_bwd`
reproduces those roundings by hand because the port fuses the affine into
the kernel (see its docstring).

Kernel design (Hopper): one Triton program per row.  A row of the
flagship (hidden 1024) fits one block, so the program reads the row once
into registers, reduces mean and variance there, and writes the
normalized, affine-transformed row once: the JAX package's two passes
(normalize in Pallas, affine in XLA) become one.  The affine epilogue
rounds the normalized row to the input dtype first, exactly as the JAX
path does, so kernel and plain version compute the same function.  The
work is a few operations per byte moved, far below what the card can do
per byte: the kernel is bound by bytes (one read of x, one write of y),
and at the decode shape (4 rows) by launch latency.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops.common import (
    check_implementation, check_operands, count_launch,
)

__all__ = [
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "fused_rms_norm",
    "fused_rms_norm_affine",
    "layer_norm_bwd",
    "layer_norm_fwd",
    "mixed_dtype_fused_layer_norm_affine",
]

KERNEL = "ln_fwd"

#: ``triton.language``, bound by :func:`_ln_kernel` on first launch so the
#: module imports without Triton (the CPU tests import it).
tl = None


def _norm_size(normalized_shape: Union[int, Sequence[int]]) -> int:
    if isinstance(normalized_shape, int):
        return normalized_shape
    size = 1
    for s in normalized_shape:
        size *= int(s)
    return size


@functools.lru_cache(maxsize=None)
def _ln_kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def ln_fwd(X, W, B, Y, Mean, Invvar, N, eps,
               RMS: tl.constexpr, HAS_BIAS: tl.constexpr,
               BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < N
        x = tl.load(X + row * N + cols, mask=mask, other=0.0)
        x = x.to(tl.float32)
        if RMS:
            mean = tl.sum(x, axis=0) * 0.0
            xc = x
        else:
            mean = tl.sum(x, axis=0) / N
            xc = tl.where(mask, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / N
        invvar = 1.0 / tl.sqrt(var + eps)
        # round the normalized row to the input dtype before the affine,
        # where the JAX path rounds it (normalize kernel, then XLA affine)
        xhat = (xc * invvar).to(Y.dtype.element_ty).to(tl.float32)
        w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
        y = xhat * w
        if HAS_BIAS:
            b = tl.load(B + cols, mask=mask, other=0.0).to(tl.float32)
            y = y + b
        tl.store(Y + row * N + cols, y.to(Y.dtype.element_ty), mask=mask)
        tl.store(Mean + row, mean)
        tl.store(Invvar + row, invvar)

    return triton, ln_fwd


def _ln_fwd_cuda(x2d, weight, bias, eps, rms):
    triton, kernel = _ln_kernel()
    if x2d.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"{KERNEL}: unsupported dtype {x2d.dtype}")
    rows, hidden = x2d.shape
    operands = [x2d, weight] + ([bias] if bias is not None else [])
    check_operands(KERNEL, *operands)
    out = torch.empty_like(x2d)
    mean = torch.empty((rows,), dtype=torch.float32, device=x2d.device)
    invvar = torch.empty_like(mean)
    if rows == 0:
        return out, mean, invvar
    block = triton.next_power_of_2(hidden)
    num_warps = min(max(block // 256, 1), 16)
    count_launch(KERNEL)
    kernel[(rows,)](
        x2d, weight, bias if bias is not None else weight, out, mean,
        invvar, hidden, float(eps), RMS=rms, HAS_BIAS=bias is not None,
        BLOCK=block, num_warps=num_warps)
    return out, mean, invvar


def _ln_fwd_plain(x2d, weight, bias, eps, rms):
    """The plain PyTorch version (CPU tests, and the on-card check)."""
    xf = x2d.float()
    if rms:
        mean = torch.zeros(xf.shape[0], dtype=torch.float32,
                           device=xf.device)
        var = torch.mean(xf * xf, dim=-1)
    else:
        mean = torch.mean(xf, dim=-1)
        xc = xf - mean[:, None]
        var = torch.mean(xc * xc, dim=-1)
    invvar = torch.rsqrt(var + eps)
    xhat = ((xf - mean[:, None]) * invvar[:, None]).to(x2d.dtype)
    y = xhat.float() * weight.reshape(-1).float()
    if bias is not None:
        y = y + bias.reshape(-1).float()
    return y.to(x2d.dtype), mean, invvar


def layer_norm_fwd(
    x2d: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float,
    rms: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize the rows of ``x2d (rows, hidden)`` and apply the affine:
    returns ``(y, mean, invvar)``, ``y`` in ``x2d``'s dtype, the
    statistics fp32 ``(rows,)`` (``mean`` is zero for RMSNorm).  ``bias``
    is None for RMSNorm.  A CUDA tensor runs the Triton kernel; a CPU
    tensor the plain version."""
    if x2d.is_cuda:
        return _ln_fwd_cuda(x2d.contiguous(), weight.contiguous(),
                            None if bias is None else bias.contiguous(),
                            eps, rms)
    if x2d.device.type == "cpu":
        return _ln_fwd_plain(x2d, weight, bias, eps, rms)
    raise ValueError(f"{KERNEL}: unsupported device {x2d.device}")


def layer_norm_bwd(
    dy: torch.Tensor,
    x2d: torch.Tensor,
    weight: torch.Tensor,
    bias_dtype: Optional[torch.dtype],
    mean: torch.Tensor,
    invvar: torch.Tensor,
    rms: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``(dx, dscale, dbias)`` of :func:`layer_norm_fwd` for the output
    cotangent ``dy`` (``bias_dtype`` None: no bias, and ``dbias`` None).

    The JAX forward is ``out = (xhat_r.f32 * w.f32 + b.f32).astype(x)``
    with ``xhat_r`` the normalized row rounded to ``x``'s dtype, and only
    the normalization inside the custom_vjp.  Its transpose, reproduced
    here: ``dxhat = (dy.f32 * w.f32)`` rounded to ``x``'s dtype,
    ``dscale = sum_rows(dy.f32 * xhat_r.f32)``, ``dbias = sum_rows(dy.f32)``
    (each cast to its parameter's dtype), then ``_normalize_bwd`` on
    ``dxhat`` with the fp32 ``xhat`` recomputed from the saved statistics,
    ``dx`` rounded to ``x``'s dtype."""
    dyf = dy.float()
    xf = x2d.float()
    xhat = (xf - mean[:, None]) * invvar[:, None]
    dscale = (dyf * xhat.to(x2d.dtype).float()).sum(0).to(weight.dtype)
    dbias = None if bias_dtype is None else dyf.sum(0).to(bias_dtype)
    dxhat = (dyf * weight.float()).to(x2d.dtype).float()
    c2 = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    if rms:
        dx = invvar[:, None] * (dxhat - xhat * c2)
    else:
        c1 = torch.mean(dxhat, dim=-1, keepdim=True)
        dx = invvar[:, None] * (dxhat - c1 - xhat * c2)
    return dx.to(x2d.dtype), dscale, dbias


class _LayerNormAffine(torch.autograd.Function):
    """The kernel's forward with :func:`layer_norm_bwd` as its backward;
    saves ``x`` and the row statistics, as the JAX custom_vjp does."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, rms):
        y, mean, invvar = layer_norm_fwd(x2d, weight, bias, eps, rms)
        ctx.save_for_backward(x2d, weight, mean, invvar)
        ctx.rms = rms
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, invvar = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(dy, x2d, weight, ctx.bias_dtype,
                                           mean, invvar, ctx.rms)
        return dx, dscale, dbias, None, None


def fused_layer_norm_affine(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    normalized_shape: Union[int, Sequence[int]],
    eps: float = 1e-5,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Affine fused layer norm, differentiable in ``x``, ``weight`` and
    ``bias``.  Output dtype follows the input; the statistics and the
    affine run in fp32.  ``implementation`` None or ``"pallas"`` (the JAX
    argument) runs the kernel."""
    check_implementation(KERNEL, implementation)
    hidden = _norm_size(normalized_shape)
    y = _LayerNormAffine.apply(x.reshape(-1, hidden), weight.reshape(-1),
                               bias.reshape(-1), eps, False)
    return y.reshape(x.shape)


def fused_rms_norm_affine(
    x: torch.Tensor,
    weight: torch.Tensor,
    normalized_shape: Union[int, Sequence[int]],
    eps: float = 1e-5,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Affine fused RMSNorm (scale only), same dtype contract, also
    differentiable; ``implementation`` as for
    :func:`fused_layer_norm_affine`."""
    check_implementation(KERNEL, implementation)
    hidden = _norm_size(normalized_shape)
    y = _LayerNormAffine.apply(x.reshape(-1, hidden), weight.reshape(-1),
                               None, eps, True)
    return y.reshape(x.shape)


def _normalize(x: torch.Tensor, normalized_shape, eps: float,
               rms: bool) -> torch.Tensor:
    """The normalized rows of ``x`` in its dtype (JAX's ``_normalize``):
    the kernel with a unit scale and no shift, differentiable in ``x``."""
    hidden = _norm_size(normalized_shape)
    ones = torch.ones(hidden, dtype=x.dtype, device=x.device)
    y = _LayerNormAffine.apply(x.reshape(-1, hidden), ones, None, eps, rms)
    return y.reshape(x.shape)


def fused_layer_norm(
    x: torch.Tensor,
    normalized_shape: Union[int, Sequence[int]],
    eps: float = 1e-5,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Layer norm without an affine, differentiable; fp32 statistics, the
    output in ``x``'s dtype.  ``implementation`` as for
    :func:`fused_layer_norm_affine`."""
    check_implementation(KERNEL, implementation)
    return _normalize(x, normalized_shape, eps, False)


def fused_rms_norm(
    x: torch.Tensor,
    normalized_shape: Union[int, Sequence[int]],
    eps: float = 1e-5,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """RMSNorm without a scale, differentiable; the dtype contract of
    :func:`fused_layer_norm`."""
    check_implementation(KERNEL, implementation)
    return _normalize(x, normalized_shape, eps, True)


def mixed_dtype_fused_layer_norm_affine(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    normalized_shape: Union[int, Sequence[int]],
    eps: float = 1e-5,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """Megatron's mixed-dtype layer norm: ``x`` may differ in dtype from
    the parameters, and the output follows the weight's.  The rows are
    normalized by the kernel (rounded to ``x``'s dtype), then ``xhat * w +
    b`` in fp32 and cast to ``weight.dtype``, as in JAX."""
    check_implementation(KERNEL, implementation)
    xhat = _normalize(x, normalized_shape, eps, False)
    out = (xhat.float() * weight.reshape(-1).float()
           + bias.reshape(-1).float())
    return out.to(weight.dtype)
