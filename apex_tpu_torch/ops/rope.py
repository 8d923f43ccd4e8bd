"""Rotary position embeddings (RoPE), plain PyTorch.

Counterpart of ``apex_tpu/ops/rope.py``, which is XLA and has no Pallas
kernel: the rotation is elementwise over the q/k projections, so it has
no kernel here either.  The fused q rotation of the paged decode kernel
(``ops/attention_decode.py``) takes its ``(cos, sin)`` rows from
:func:`rope_table`.

Convention, as in JAX: half-split rotation (Llama/NeoX), the first half
of the head dim paired with the second, angles ``p * base**(-i/half)``.
The trig runs in fp32 whatever the activation dtype, the rotation in
fp32, and the result is cast back to the input dtype.

:func:`rope_table` rows are computed by the very expression
:func:`rope_cos_sin` evaluates, so gathering row ``p`` is bit-identical
to computing position ``p`` directly: prefill rotates K with direct
tables, decode gathers rows of the cached table, and the two must not
drift (``tests/test_torch_rope.py`` pins it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["rope_cos_sin", "apply_rope", "apply_rope_tables", "rope_table",
           "apply_rope_at"]


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 base: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of shape ``positions.shape + (head_dim // 2,)``,
    fp32, on ``positions``' device."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    exponent = -torch.arange(half, dtype=torch.float32,
                             device=positions.device) / half
    inv_freq = torch.pow(torch.tensor(base, dtype=torch.float32,
                                      device=positions.device), exponent)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x (..., seq, head_dim)`` by precomputed tables of shape
    ``(seq, head_dim/2)`` (or anything that broadcasts to
    ``x[..., :head_dim/2]``); fp32 math, result in ``x``'s dtype."""
    d = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None, *,
               base: float = 10000.0, position_offset: int = 0
               ) -> torch.Tensor:
    """Rotate ``x (..., seq, head_dim)`` by its positions, by default
    ``position_offset + arange(seq)``."""
    seq, d = x.shape[-2], x.shape[-1]
    if positions is None:
        positions = position_offset + torch.arange(seq, dtype=torch.int32,
                                                   device=x.device)
    cos, sin = rope_cos_sin(positions, d, base)
    return apply_rope_tables(x, cos, sin)


#: ``(max_len, head_dim, dtype, base, device) -> (cos, sin)``: decode
#: rotates one position per sequence and step, so the whole table is built
#: once and each step gathers rows
_TABLE_CACHE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_table(max_len: int, head_dim: int, dtype=torch.float32,
               base: float = 10000.0,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cached ``(cos, sin)`` tables of shape ``(max_len, head_dim//2)``
    in ``dtype`` on ``device`` (default the CPU), keyed by ``(max_len,
    head_dim, dtype, base, device)``: the JAX signature, with the device
    last.  The rows are computed in fp32 by the very expression
    :func:`rope_cos_sin` evaluates and then cast, so at fp32 gathering row
    ``p`` is bit-identical to computing position ``p`` directly; a
    narrower ``dtype`` trades table bytes for that identity, as in JAX."""
    device = torch.device("cpu" if device is None else device)
    key = (int(max_len), int(head_dim), dtype, float(base), device)
    hit = _TABLE_CACHE.get(key)
    if hit is None:
        cos, sin = rope_cos_sin(
            torch.arange(max_len, dtype=torch.int32, device=device),
            head_dim, base)
        hit = (cos.to(dtype), sin.to(dtype))
        _TABLE_CACHE[key] = hit
    return hit


def apply_rope_at(x: torch.Tensor, positions: torch.Tensor, *,
                  base: float = 10000.0, max_len: Optional[int] = None,
                  tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Rotate ``x`` at arbitrary positions: ``(s,)`` shared by the batch
    (any ``x (..., s, d)``) or ``(b, s)`` per sequence (``x (b, h, s,
    d)``).  Rows come from ``tables``, from the :func:`rope_table` cache
    when ``max_len`` is given, or are computed directly; all three are
    bit-identical."""
    d = x.shape[-1]
    positions = torch.as_tensor(positions, device=x.device)
    if tables is None and max_len is not None:
        tables = rope_table(max_len, d, base=base, device=x.device)
    if tables is not None:
        idx = positions.long()
        cos, sin = tables[0][idx].float(), tables[1][idx].float()
    else:
        cos, sin = rope_cos_sin(positions, d, base)
    if positions.ndim == 2:
        if x.ndim != 4:
            raise ValueError(
                f"per-sequence (b, s) positions need x of shape (b, h, s, "
                f"d), got {tuple(x.shape)}")
        cos, sin = cos[:, None], sin[:, None]
    return apply_rope_tables(x, cos, sin)
