"""Fused LayerNorm / RMSNorm: the CUDA forward and fused backward
(``csrc/layer_norm.cu``), their plain versions, and the entry points.

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

The backward is a kernel too (``ln_bwd``, then ``ln_bwd_fold``), though
the JAX package's is XLA math (``_normalize_bwd`` and the transpose of
the affine): as plain PyTorch it cost ~20 launches a norm, most of them
writing an fp32 ``(rows, hidden)`` intermediate.  The JAX affine runs
outside its custom_vjp, so its transpose rounds where the forward
rounded; :func:`layer_norm_bwd` reproduces those roundings because the
port fuses the affine into the kernel (see its docstring).

Kernel design (``csrc/layer_norm.cu``): one warp per row, the row in
registers as 16-byte vectors, statistics by warp shuffles; the backward's
column sums (``dscale``, ``dbias``) per block in a fixed order into an
fp32 scratch of partials, added in block order by a second kernel, so a
call gives the same bits every run.  :func:`layer_norm_plan` computes the
grids and the scratch from the shapes alone.  Both kernels are bound by
bytes (one read of x, one write of y; one read of x and dy, one write of
dx), and at the decode shape (4 rows) by launch latency.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops.common import (
    check, check_implementation, check_operands, count_launch, load,
    stream_of,
)

__all__ = [
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "fused_rms_norm",
    "fused_rms_norm_affine",
    "layer_norm_bwd",
    "layer_norm_fwd",
    "layer_norm_plan",
    "mixed_dtype_fused_layer_norm_affine",
]

KERNEL = "ln_fwd"
KERNEL_BWD = "ln_bwd"
KERNEL_FOLD = "ln_bwd_fold"

#: the kernels' dtype codes (x, and the weight and bias)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: warps a forward block, and its blocks at most (four an SM of an H100's
#: 132): past that a warp walks several rows
FWD_WARPS = 4
FWD_MAX_BLOCKS = 528
#: the backward's blocks at most (one an SM of an H100's 132) and warps
#: a block
BWD_MAX_BLOCKS = 132
BWD_WARPS = 8
#: the fold's runs of blocks (a warp each), added in order
FOLD_RUNS = 8
#: shared memory the backward's block may take: each warp's column sums,
#: 8 bytes a column
SMEM_LIMIT = 224 * 1024
#: the widest row the kernels take: one warp's column sums in SMEM_LIMIT
MAX_HIDDEN = SMEM_LIMIT // 8

ARGTYPES = {
    "ln_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "ln_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "ln_bwd_fold": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


def _norm_size(normalized_shape: Union[int, Sequence[int]]) -> int:
    if isinstance(normalized_shape, int):
        return normalized_shape
    size = 1
    for s in normalized_shape:
        size *= int(s)
    return size


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class LayerNormPlan(NamedTuple):
    """The launch of both kernels for one shape (no data read)."""

    vec: bool            # 16-byte instances: hidden a multiple of 16 bytes
    fwd_grid: int        # forward blocks of FWD_WARPS warps
    warps: int           # backward warps a block
    rows_per_block: int  # backward rows a block (a multiple of warps)
    blocks: int          # backward blocks = partials a column
    partials: int        # fp32 elements of the (2, blocks, hidden) scratch


@functools.lru_cache(maxsize=4096)
def layer_norm_plan(rows: int, hidden: int, x_dtype: torch.dtype,
                    w_dtype: torch.dtype) -> LayerNormPlan:
    """The grids, the backward's row split and its scratch from the shapes
    alone.  x and the parameters may be fp32, bf16 or fp16; ``hidden``
    runs from 1 to :data:`MAX_HIDDEN` (28672): past it one warp's column
    sums no longer fit the block's shared memory, and the kernels raise
    ``ValueError``.  The backward's block k takes rows [k * rows_per_block,
    (k + 1) * rows_per_block), its warp w rows w, w + warps, ...: at most
    :data:`BWD_MAX_BLOCKS` blocks."""
    for what, dt in (("x", x_dtype), ("weight", w_dtype)):
        if dt not in _DTYPES:
            raise ValueError(f"{KERNEL}: {what} dtype {dt} is not one of "
                             f"{list(_DTYPES)}")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"{KERNEL}: hidden {hidden} is outside the "
                         f"kernels' 1..{MAX_HIDDEN}")
    warps, rows_per_block, blocks = _bwd_split(rows, hidden)
    return LayerNormPlan(hidden % (16 // x_dtype.itemsize) == 0,
                         min(_cdiv(rows, FWD_WARPS), FWD_MAX_BLOCKS), warps,
                         rows_per_block, blocks, 2 * blocks * hidden)


def _bwd_split(rows: int, hidden: int) -> Tuple[int, int, int]:
    """The backward's ``(warps, rows_per_block, blocks)``: as many blocks
    as :data:`BWD_MAX_BLOCKS` allows, each a whole number of rows a warp
    (the plain version's too, whatever the dtype or width)."""
    warps = max(1, min(BWD_WARPS, SMEM_LIMIT // (8 * hidden)))
    rows_per_block = max(warps,
                         _cdiv(_cdiv(rows, BWD_MAX_BLOCKS), warps) * warps)
    return warps, rows_per_block, _cdiv(rows, rows_per_block)


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The loaded library and its C entry, typed once."""
    lib = load("layer_norm")
    fn = getattr(lib, symbol)
    fn.argtypes = ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return lib, fn


def _vec(plan: LayerNormPlan, *tensors: Optional[torch.Tensor]) -> int:
    """1 for the 16-byte instances: the shape allows them and every
    operand starts on a 16-byte boundary."""
    return int(plan.vec and all(t is None or t.data_ptr() % 16 == 0
                                for t in tensors))


def _check_params(kernel, hidden, weight, bias_dtype):
    if weight.numel() != hidden:
        raise ValueError(f"{kernel}: weight of {weight.numel()} elements "
                         f"for rows of {hidden}")
    if bias_dtype is not None and bias_dtype != weight.dtype:
        raise ValueError(f"{kernel}: bias dtype {bias_dtype} differs from "
                         f"the weight's {weight.dtype}")


def _ln_fwd_cuda(x2d, weight, bias, eps, rms):
    rows, hidden = x2d.shape
    plan = layer_norm_plan(rows, hidden, x2d.dtype, weight.dtype)
    _check_params(KERNEL, hidden, weight,
                  None if bias is None else bias.dtype)
    check_operands(KERNEL, x2d, weight,
                   *([bias] if bias is not None else []))
    out = torch.empty_like(x2d)
    mean = torch.empty((rows,), dtype=torch.float32, device=x2d.device)
    invvar = torch.empty_like(mean)
    if rows == 0:
        return out, mean, invvar
    lib, fn = _entry(KERNEL)
    count_launch(KERNEL)
    err = fn(x2d.data_ptr(), weight.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             mean.data_ptr(), invvar.data_ptr(), rows, hidden, float(eps),
             int(rms), _DTYPES[x2d.dtype], _DTYPES[weight.dtype],
             _vec(plan, x2d, weight, bias, out), FWD_WARPS, plan.fwd_grid,
             stream_of(x2d))
    check(lib, KERNEL, err)
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
    is None for RMSNorm.  A CUDA tensor runs the kernel (``ln_fwd``); a
    CPU tensor the plain version."""
    if x2d.is_cuda:
        return _ln_fwd_cuda(x2d.contiguous(), weight.contiguous(),
                            None if bias is None else bias.contiguous(),
                            eps, rms)
    if x2d.device.type == "cpu":
        return _ln_fwd_plain(x2d, weight, bias, eps, rms)
    raise ValueError(f"{KERNEL}: unsupported device {x2d.device}")


def _partials_plain(terms: torch.Tensor) -> torch.Tensor:
    """``terms (k, rows, hidden)`` fp32 summed into the backward blocks'
    partials ``(k, blocks, hidden)`` in the kernel's order: each warp adds
    its rows in row order, each block its warps in warp order.  Rows past
    ``rows`` add zeros, as the kernel's idle warps contribute them."""
    k, rows, hidden = terms.shape
    warps, rows_per_block, blocks = _bwd_split(rows, hidden)
    per_warp = rows_per_block // warps
    pad = blocks * rows_per_block - rows
    t = torch.cat([terms, terms.new_zeros((k, pad, hidden))], dim=1).view(
        k, blocks, per_warp, warps, hidden)
    acc = t[:, :, 0]
    for j in range(1, per_warp):
        acc = acc + t[:, :, j]
    part = acc[:, :, 0]
    for w in range(1, warps):
        part = part + acc[:, :, w]
    return part


def _fold_plain(partials: torch.Tensor) -> torch.Tensor:
    """``ln_bwd_fold``'s sums of the partials ``(k, blocks, hidden)``,
    ``(k, hidden)``: :data:`FOLD_RUNS` runs of consecutive blocks, each
    added in block order, then the runs in order (a run past the last
    block adds zeros)."""
    k, blocks, hidden = partials.shape
    run = _cdiv(blocks, FOLD_RUNS)
    pad = FOLD_RUNS * run - blocks
    t = torch.cat([partials, partials.new_zeros((k, pad, hidden))],
                  dim=1).view(k, FOLD_RUNS, run, hidden)
    acc = t[:, :, 0]
    for j in range(1, run):
        acc = acc + t[:, :, j]
    total = acc[:, 0]
    for r in range(1, FOLD_RUNS):
        total = total + acc[:, r]
    return total


def _column_sums_plain(terms: torch.Tensor) -> torch.Tensor:
    """``terms (k, rows, hidden)`` summed over the rows as the two kernels
    sum them (:func:`_partials_plain`, then :func:`_fold_plain`):
    ``(k, hidden)``."""
    k, rows, hidden = terms.shape
    if rows == 0:
        return terms.new_zeros((k, hidden))
    return _fold_plain(_partials_plain(terms))


def _ln_bwd_plain(dy, x2d, weight, bias_dtype, mean, invvar, rms,
                  params=True):
    """The plain PyTorch version of both backward kernels (CPU tests, and
    the on-card check); see :func:`layer_norm_bwd`."""
    dyf = dy.float()
    xf = x2d.float()
    xhat = (xf - mean[:, None]) * invvar[:, None]
    dxhat = (dyf * weight.reshape(-1).float()).to(x2d.dtype).float()
    c2 = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    if rms:
        dx = invvar[:, None] * (dxhat - xhat * c2)
    else:
        c1 = torch.mean(dxhat, dim=-1, keepdim=True)
        dx = invvar[:, None] * (dxhat - c1 - xhat * c2)
    dx = dx.to(x2d.dtype)
    if not params:
        return dx, None, None
    sums = _column_sums_plain(
        torch.stack([dyf * xhat.to(x2d.dtype).float(), dyf]))
    dbias = None if bias_dtype is None else sums[1].to(bias_dtype)
    return dx, sums[0].to(weight.dtype), dbias


def _ln_bwd_cuda(dy, x2d, weight, bias_dtype, mean, invvar, rms, params):
    rows, hidden = x2d.shape
    plan = layer_norm_plan(rows, hidden, x2d.dtype, weight.dtype)
    _check_params(KERNEL_BWD, hidden, weight, bias_dtype)
    if dy.shape != x2d.shape or dy.dtype != x2d.dtype:
        raise ValueError(f"{KERNEL_BWD}: dy {tuple(dy.shape)} {dy.dtype} "
                         f"for x {tuple(x2d.shape)} {x2d.dtype}")
    check_operands(KERNEL_BWD, dy, x2d, weight, mean, invvar)
    dev = x2d.device
    dx = torch.empty_like(x2d)
    dscale = dbias = None
    if params:
        # no rows: the sums are zeros and no kernel runs
        new = torch.zeros if rows == 0 else torch.empty
        dscale = new(hidden, dtype=weight.dtype, device=dev)
        if bias_dtype is not None:
            dbias = new(hidden, dtype=bias_dtype, device=dev)
    if rows == 0:
        return dx, dscale, dbias
    # from the caching allocator on the current stream, so a captured
    # graph keeps its own
    partials = (torch.empty(plan.partials, dtype=torch.float32, device=dev)
                if params else None)
    stream = stream_of(x2d)
    lib, fn = _entry(KERNEL_BWD)
    count_launch(KERNEL_BWD)
    err = fn(dy.data_ptr(), x2d.data_ptr(), weight.data_ptr(),
             mean.data_ptr(), invvar.data_ptr(), dx.data_ptr(),
             None if partials is None else partials.data_ptr(), rows, hidden,
             int(rms), _DTYPES[x2d.dtype], _DTYPES[weight.dtype],
             _vec(plan, dy, x2d, weight, dx), plan.warps,
             plan.rows_per_block, plan.blocks, stream)
    check(lib, KERNEL_BWD, err)
    if params:
        _fold_cuda(partials, dscale, dbias, plan.blocks, hidden, stream)
    return dx, dscale, dbias


def _fold_cuda(partials, dscale, dbias, blocks, hidden, stream) -> None:
    """``ln_bwd_fold``: ``dscale`` (and ``dbias`` unless None), both of one
    dtype, from the fp32 partials ``(2, blocks, hidden)``."""
    lib, fold = _entry(KERNEL_FOLD)
    count_launch(KERNEL_FOLD)
    err = fold(partials.data_ptr(), dscale.data_ptr(),
               None if dbias is None else dbias.data_ptr(), blocks, hidden,
               _DTYPES[dscale.dtype], stream)
    check(lib, KERNEL_FOLD, err)


def layer_norm_bwd(
    dy: torch.Tensor,
    x2d: torch.Tensor,
    weight: torch.Tensor,
    bias_dtype: Optional[torch.dtype],
    mean: torch.Tensor,
    invvar: torch.Tensor,
    rms: bool,
    *,
    params: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dx, dscale, dbias)`` of :func:`layer_norm_fwd` for the output
    cotangent ``dy`` (``bias_dtype`` None: no bias, and ``dbias`` None;
    ``params=False``: ``dx`` alone, the parameter gradients None).

    The JAX forward is ``out = (xhat_r.f32 * w.f32 + b.f32).astype(x)``
    with ``xhat_r`` the normalized row rounded to ``x``'s dtype, and only
    the normalization inside the custom_vjp.  Its transpose, reproduced
    here: ``dxhat = (dy.f32 * w.f32)`` rounded to ``x``'s dtype,
    ``dscale = sum_rows(dy.f32 * xhat_r.f32)``, ``dbias = sum_rows(dy.f32)``
    (each cast to its parameter's dtype, the sums taken in the kernels'
    fixed order, :func:`_column_sums_plain`), then ``_normalize_bwd`` on
    ``dxhat`` with the fp32 ``xhat`` recomputed from the saved statistics,
    ``dx`` rounded to ``x``'s dtype.  A CUDA tensor runs the kernels
    (``ln_bwd``, then ``ln_bwd_fold`` for the parameter gradients); a CPU
    tensor the plain version."""
    if x2d.is_cuda:
        return _ln_bwd_cuda(dy.contiguous(), x2d.contiguous(),
                            weight.contiguous(), bias_dtype,
                            mean.contiguous(), invvar.contiguous(), rms,
                            params)
    if x2d.device.type == "cpu":
        return _ln_bwd_plain(dy, x2d, weight, bias_dtype, mean, invvar, rms,
                             params)
    raise ValueError(f"{KERNEL_BWD}: unsupported device {x2d.device}")


class _LayerNormAffine(torch.autograd.Function):
    """The forward kernel with :func:`layer_norm_bwd` as its backward;
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
        dx, dscale, dbias = layer_norm_bwd(
            dy, x2d, weight, ctx.bias_dtype, mean, invvar, ctx.rms,
            params=any(ctx.needs_input_grad[1:3]))
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
    hidden = _norm_size(normalized_shape)
    xhat = _normalize(x, normalized_shape, eps, False).reshape(-1, hidden)
    out = (xhat.float() * weight.reshape(-1).float()
           + bias.reshape(-1).float())
    return out.to(weight.dtype).reshape(x.shape)
