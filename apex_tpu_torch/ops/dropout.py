"""Hidden dropout with JAX's masks: a Triton kernel and its plain version.

The JAX GPT drops its hidden activations at two places in every layer,
the attention projection's output and the MLP's output, before each
residual add (``apex_tpu/models/gpt.py:802-808``, ``:819-822``)::

    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    x = jnp.where(keep, x / (1.0 - rate), 0.0)

That is XLA, not Pallas, so no TPU kernel is replaced here; XLA fuses the
threefry draw into one elementwise pass.  Plain PyTorch cannot: threefry
over a flagship activation (8 x 1024 x 1024) is some 200 elementwise
int64 launches of 64 MB each, about 8 ms, at 72 site passes a training
step (12 layers x 2 sites x forward, remat recompute and backward).  So
:func:`dropout_fwd` on a CUDA tensor launches one fused Triton pass: each
program hashes its flat indices with threefry2x32 (the counter ``(n >>
32, n & 0xffffffff)`` under the key, as ``jax.random.bits`` in
partitionable mode), turns the bits into JAX's float32 uniform, keeps an
element where it is below ``float32(1 - rate)`` and writes ``x / (1 -
rate)`` or 0 in ``x``'s dtype.  It reads ``x`` once and writes ``y``
once, no mask in memory.  The least time is the larger of the bytes over
the memory rate and the hash's operations (:data:`HASH_OPS` 32-bit integer
operations an element, no tensor-core rate) over the card's 67 T/s of
32-bit operations.  Counted as ``dropout``; an fp16 tensor (the opt levels
O1-O3) launches the kernel's fp16 instance, counted as ``dropout_f16``.

The scale: JAX divides by ``1.0 - rate``, a weakly typed Python float
that becomes the activation's dtype first, so in bf16 the divisor is
``bf16(0.9) = 0.8984375``, and a bf16 result is
``bf16(float32(x) / 0.8984375)``; in fp16 ``fp16(0.9) = 0.89990234375``.
(A quotient of two fp16 values taken in fp32 and rounded to fp16 is the
correctly rounded fp16 quotient: 24 >= 2 * 11 + 2 bits.)  The kernel and
the plain version both
divide (correctly rounded, ``div_rn``) by that dtype-rounded value; a
multiply by ``1 / (1 - rate)`` would give other bf16 bits.  (Under
``jit`` XLA turns an fp32 division by a constant into a multiply by its
fp32 reciprocal, one fp32 ulp from the division; eager JAX divides.)

:func:`dropout` is differentiable: the backward saves only the key and
the rate and runs the same pass on the gradient (the vjp of ``where(keep,
x / c, 0)`` is ``where(keep, g / c, 0)``), so no mask is stored and remat
replays the same mask from the same key.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from apex_tpu_torch.ops.common import as_int32, count_launch
from apex_tpu_torch.random import uniform_tensor

__all__ = ["dropout", "dropout_fwd", "dropout_mask", "divisor", "KERNEL",
           "KERNEL_F16", "HASH_OPS", "DTYPES"]

KERNEL = "dropout"
KERNEL_F16 = "dropout_f16"
#: the element types the kernel takes
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: 32-bit integer operations an element: threefry2x32's 20 rounds (an add,
#: a rotate as two shifts and an or, an xor: 5 each) and 5 key injections
#: (3 adds each, the schedule's xors folded), the counter split, the xor of
#: the two words, the mantissa shift and or, the compare and the select
HASH_OPS = 20 * 5 + 5 * 3 + 2 + 1 + 2 + 2
#: elements a Triton program draws
BLOCK = 1024


def keep_prob(rate: float) -> np.float32:
    """``float32(1 - rate)``: JAX's ``bernoulli`` threshold (a weakly
    typed Python float becomes float32)."""
    return np.float32(1.0 - rate)


def divisor(rate: float, dtype: torch.dtype) -> float:
    """``1 - rate`` rounded to ``dtype`` (straight from the Python
    double, as JAX converts a weak scalar), as a Python float."""
    return float(torch.tensor(1.0 - rate, dtype=torch.float64).to(dtype))


def dropout_mask(key, shape, rate: float, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, 1 - rate, shape)`` as a bool tensor on
    ``device`` (the GPU unless it says otherwise), in plain PyTorch."""
    return uniform_tensor(key, shape, device) < keep_prob(rate)


def _dropout_plain(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """The plain version: JAX's mask, ``x / divisor`` in fp32 rounded to
    ``x``'s dtype where kept, else 0.  The divisor is a tensor on ``x``'s
    device: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, one fp32 ulp from the division."""
    keep = dropout_mask(key, x.shape, rate, x.device)
    div = torch.full((), divisor(rate, x.dtype), dtype=torch.float32,
                     device=x.device)
    y = (x.float() / div).to(x.dtype)
    return torch.where(keep, y, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


#: ``triton.language`` and the threefry helpers, bound by
#: :func:`threefry_jit` on first launch so the module imports without
#: Triton (the CPU tests import it); the kernels find them as globals.
tl = None
_four_rounds = None
_threefry2x32 = None


@functools.lru_cache(maxsize=None)
def threefry_jit():
    """The Triton ``threefry2x32(a, b, x0, x1) -> (y0, y1)`` of uint32
    key words ``a``/``b`` and counters, for any kernel that draws JAX's
    bits (this module's and ``ops/sampling.py``'s).  Its constants are
    threefry's (:data:`apex_tpu_torch.random.ROTATIONS`, ``PARITY``)
    written out: five groups of four rounds, a key injection after
    each."""
    global tl, _four_rounds, _threefry2x32
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def four_rounds(x0, x1, ra: tl.constexpr, rb: tl.constexpr,
                    rc: tl.constexpr, rd: tl.constexpr):
        x0 = x0 + x1
        x1 = (x1 << ra) | (x1 >> (32 - ra))
        x1 = x0 ^ x1
        x0 = x0 + x1
        x1 = (x1 << rb) | (x1 >> (32 - rb))
        x1 = x0 ^ x1
        x0 = x0 + x1
        x1 = (x1 << rc) | (x1 >> (32 - rc))
        x1 = x0 ^ x1
        x0 = x0 + x1
        x1 = (x1 << rd) | (x1 >> (32 - rd))
        x1 = x0 ^ x1
        return x0, x1

    _four_rounds = four_rounds

    @triton.jit
    def threefry2x32(a, b, x0, x1):
        c = a ^ b ^ 0x1BD11BDA
        x0 = x0 + a
        x1 = x1 + b
        x0, x1 = _four_rounds(x0, x1, 13, 15, 26, 6)
        x0 = x0 + b
        x1 = x1 + c + 1
        x0, x1 = _four_rounds(x0, x1, 17, 29, 16, 24)
        x0 = x0 + c
        x1 = x1 + a + 2
        x0, x1 = _four_rounds(x0, x1, 13, 15, 26, 6)
        x0 = x0 + a
        x1 = x1 + b + 3
        x0, x1 = _four_rounds(x0, x1, 17, 29, 16, 24)
        x0 = x0 + b
        x1 = x1 + c + 4
        x0, x1 = _four_rounds(x0, x1, 13, 15, 26, 6)
        x0 = x0 + c
        x1 = x1 + a + 5
        return x0, x1

    _threefry2x32 = threefry2x32
    return threefry2x32


@functools.lru_cache(maxsize=None)
def _dropout_kernel():
    """Build the Triton kernel over :func:`threefry_jit`'s hash."""
    import triton

    threefry_jit()

    @triton.jit(do_not_specialize=["n", "k0", "k1"])
    def dropout_kernel(X, Y, n, k0, k1, keep_p, div, BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        inb = offs < n
        x = tl.load(X + offs, mask=inb, other=0.0)
        # threefry2x32 of the counter (offs >> 32, offs & 0xffffffff)
        x0, x1 = _threefry2x32(k0.to(tl.uint32, bitcast=True),
                               k1.to(tl.uint32, bitcast=True),
                               (offs >> 32).to(tl.uint32),
                               (offs & 0xFFFFFFFF).to(tl.uint32))
        bits = x0 ^ x1
        # JAX's float32 uniform: 23 random mantissa bits of [1, 2), minus 1
        u = ((bits >> 9) | 0x3F800000).to(tl.float32, bitcast=True) - 1.0
        y = tl.math.div_rn(x.to(tl.float32), div)
        y = tl.where(u < keep_p, y, 0.0)
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=inb)

    return triton, dropout_kernel


def _dropout_cuda(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    if x.dtype not in DTYPES:
        raise ValueError(f"{KERNEL}: dtype {x.dtype} not in {DTYPES}")
    triton, kernel = _dropout_kernel()
    x = x.contiguous()
    y = torch.empty_like(x)
    n = x.numel()
    k = np.asarray(key, dtype=np.uint32)
    count_launch(KERNEL_F16 if x.dtype == torch.float16 else KERNEL)
    kernel[(triton.cdiv(n, BLOCK),)](
        x, y, n, as_int32(k[0]), as_int32(k[1]),
        float(keep_prob(rate)), divisor(rate, x.dtype), BLOCK=BLOCK,
        num_warps=4)
    return y


def dropout_fwd(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """``where(bernoulli(key, 1 - rate, x.shape), x / (1 - rate), 0)``
    with JAX's mask and rounding; ``key`` a host key of
    :mod:`apex_tpu_torch.random`.  A CUDA tensor runs the kernel, a CPU
    tensor the plain version."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{KERNEL}: rate {rate} not in [0, 1)")
    if x.numel() == 0:
        return x.clone()
    if x.is_cuda:
        return _dropout_cuda(x, key, rate)
    if x.device.type == "cpu":
        return _dropout_plain(x, key, rate)
    raise ValueError(f"{KERNEL}: unsupported device {x.device}")


class _Dropout(torch.autograd.Function):
    """Saves the key and the rate only; the backward runs the same pass
    on the gradient."""

    @staticmethod
    def forward(ctx, x, key, rate):
        ctx.key, ctx.rate = key, rate
        return dropout_fwd(x, key, rate)

    @staticmethod
    def backward(ctx, g):
        return dropout_fwd(g, ctx.key, ctx.rate), None, None


def dropout(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    """Differentiable :func:`dropout_fwd`; ``rate == 0`` returns ``x``."""
    if rate == 0.0:
        return x
    return _Dropout.apply(x, key, rate)
