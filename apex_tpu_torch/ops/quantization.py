"""Block-wise int8 and packed int4 quantization of weight pools and KV rows.

Counterpart of the weight-pool and KV subset of
``apex_tpu/ops/quantization.py``: :func:`quantize_rows` (per-row blocks of
``block_size`` elements share one fp32 scale, ``max|block| / 127``),
:func:`pack_int4` / :func:`unpack_int4` (two nibbles per byte in the
halves layout: packed column ``c`` holds column ``c`` in its low nibble
and column ``c + n/2`` in its high nibble) and :func:`quantize_rows_int4`
(``max|block| / 7``).  Plain PyTorch, bit-identical to the JAX package:
the same operations in the same order (``amax / 127``, then ``x / scale``,
clip, round half to even, clip), all-zero blocks get scale 1, and the
int4 two's-complement step is an explicit ``where``, not a wrapping cast.

Not ported yet: stochastic rounding and the quantized collectives'
helpers (``quantize_blockwise``, ``quantized_psum``, ...), which come
with tensor parallelism and the gradient collectives (ROADMAP.md queue A
item 9).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "quantize_rows",
    "dequantize_rows",
    "pack_int4",
    "unpack_int4",
    "quantize_rows_int4",
    "dequantize_rows_int4",
]

_INT8_MAX = 127.0
_INT4_MAX = 7.0


def _check_row_blocks(n: int, block_size: int, leaf: Optional[str],
                      shape) -> None:
    """The weight-pool seam's block validation: a caller that names its
    ``leaf`` opts into whole blocks only, with an error naming the leaf
    (without one the row is zero-padded to whole blocks, as the
    collectives want)."""
    if leaf is None:
        return
    if block_size < 1 or n % block_size:
        raise ValueError(
            f"block_size={block_size} does not divide the row length "
            f"of leaf {leaf!r} (shape {tuple(shape)}, rows of "
            f"{n} elements): the in-kernel dequant tiles need whole "
            f"blocks — pick a block_size that divides {n} (e.g. a "
            f"power of two that divides the hidden/ffn width)")


def quantize_rows(
    x: torch.Tensor,
    block_size: int = 256,
    rounding: str = "nearest",
    *,
    leaf: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row block-wise int8 quantize of a 2-D ``(rows, n)`` tensor:
    blocks never straddle rows.  Returns ``(values int8 (rows, n),
    scales fp32 (rows, ceil(n / block_size)))``.  ``leaf`` turns on the
    strict whole-block check of the weight pools."""
    if rounding != "nearest":
        raise NotImplementedError(
            f"rounding={rounding!r} is not ported yet (ROADMAP.md queue A "
            "item 9, the quantized collectives); the weight pools and KV "
            "pages round to nearest")
    rows, n = x.shape
    _check_row_blocks(n, block_size, leaf, x.shape)
    nb = max(-(-n // block_size), 1)
    pad = nb * block_size - n
    xf = x.to(torch.float32)
    if pad:
        xf = torch.cat(
            [xf, torch.zeros((rows, pad), dtype=torch.float32,
                             device=x.device)], dim=1)
    xb = xf.reshape(rows, nb, block_size)
    amax = xb.abs().amax(dim=2)
    scales = torch.where(amax > 0.0, amax / _INT8_MAX,
                         torch.ones_like(amax))
    v = torch.clamp(xb / scales[:, :, None], -_INT8_MAX, _INT8_MAX)
    q = torch.clamp(torch.round(v), -_INT8_MAX, _INT8_MAX).to(torch.int8)
    return q.reshape(rows, nb * block_size)[:, :n], scales


def dequantize_rows(
    values: torch.Tensor,
    scales: torch.Tensor,
    block_size: int = 256,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (up to rounding error): each value
    times its block's scale, in fp32, then cast to ``dtype``."""
    rows, n = values.shape
    expand = torch.repeat_interleave(scales, block_size, dim=1)[:, :n]
    return (values.to(torch.float32) * expand).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, each in ``[-8, 7]``) two nibbles
    per byte in the halves layout.  Returns int8 ``(rows, n // 2)``;
    ``n`` must be even."""
    rows, n = q.shape
    if n % 2:
        raise ValueError(
            f"pack_int4 needs an even row length to pair nibbles, got "
            f"shape {tuple(q.shape)}")
    x = q.to(torch.int32)
    lo = x[:, : n // 2] & 0xF
    hi = x[:, n // 2:] & 0xF
    p = lo | (hi << 4)
    # two's-complement re-interpretation into int8 storage (128..255 map
    # to -128..-1), explicit rather than a wrapping cast
    return torch.where(p < 128, p, p - 256).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 ``(rows, n/2)`` packed bytes ->
    int8 ``(rows, n)`` values in ``[-8, 7]``, sign-extended by
    ``(x ^ 8) - 8``."""
    x = packed.to(torch.int32) & 0xFF
    lo = ((x & 0xF) ^ 8) - 8
    hi = (((x >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize_rows_int4(
    x: torch.Tensor,
    block_size: int = 128,
    *,
    leaf: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row block-wise int4 quantize of a 2-D ``(rows, n)`` tensor
    (``scale = max|block| / 7``, round half to even, all-zero blocks get
    scale 1), packed by :func:`pack_int4`.  Returns ``(packed int8 (rows,
    n // 2), scales fp32 (rows, n / block_size))``.  ``block_size`` must
    be even and ``n`` a multiple of ``2 * block_size``, so each packed
    half holds whole scale blocks; ``leaf`` names the weight in the
    errors."""
    rows, n = x.shape
    at = "" if leaf is None else f" of leaf {leaf!r}"
    if block_size < 2 or block_size % 2:
        raise ValueError(
            f"int4 block_size must be even (two nibbles per byte — an "
            f"odd block cannot pair its last nibble), got "
            f"{block_size}{at}")
    if n % 2:
        raise ValueError(
            f"int4 quantization needs an even row length{at}, got "
            f"shape {tuple(x.shape)}")
    if n % (2 * block_size):
        raise ValueError(
            f"block_size={block_size} does not tile the int4 halves "
            f"layout{at} (shape {tuple(x.shape)}): the row length "
            f"must be a multiple of 2 * block_size = {2 * block_size} "
            f"so each packed half holds whole scale blocks — pick a "
            f"smaller even block_size that divides {n // 2}")
    nb = n // block_size
    xb = x.to(torch.float32).reshape(rows, nb, block_size)
    amax = xb.abs().amax(dim=2)
    scales = torch.where(amax > 0.0, amax / _INT4_MAX,
                         torch.ones_like(amax))
    v = torch.clamp(xb / scales[:, :, None], -_INT4_MAX, _INT4_MAX)
    q = torch.clamp(torch.round(v), -_INT4_MAX, _INT4_MAX).to(torch.int8)
    return pack_int4(q.reshape(rows, n)), scales


def dequantize_rows_int4(
    packed: torch.Tensor,
    scales: torch.Tensor,
    block_size: int = 128,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Inverse of :func:`quantize_rows_int4` (up to rounding error)."""
    return dequantize_rows(unpack_int4(packed), scales, block_size, dtype)
