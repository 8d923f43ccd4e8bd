"""Convnet building blocks: the NHWC convolution and He init.

Counterpart of ``apex_tpu/utils/convnet.py``.  Activations are NHWC and
weights HWIO, as in JAX; the convolution is ``F.conv2d`` (cuDNN on the
card, as JAX's is XLA's), called on the NCHW view of the NHWC tensor,
which is a ``channels_last`` tensor, with the weight viewed as OIHW.

``"SAME"`` padding is XLA's: each spatial dim is padded to ``ceil(in /
stride)`` outputs, ``lo = total // 2`` before and the rest after.  For a
stride-2 window that is asymmetric (the 7x7 stem on 224 pads 2 before and
3 after, a 3x3 stride-2 conv on 56 pads 0 and 1), which ``F.conv2d``'s
symmetric ``padding`` cannot say, so such a pad is an explicit ``F.pad``
and the convolution runs unpadded.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["conv_nhwc", "he_init", "same_pads", "max_pool_nhwc"]

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: Sequence[int], window: Sequence[int],
              stride: int) -> Tuple[Tuple[int, int], ...]:
    """XLA's ``"SAME"`` ``(lo, hi)`` pads of each spatial dim."""
    pads = []
    for n, k in zip(size, window):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pads(padding: Padding, size, window, stride: int):
    if padding == "SAME":
        return same_pads(size, window, stride)
    if padding == "VALID":
        return ((0, 0),) * len(window)
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _padded(xc: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """``xc (N, C, H, W)`` padded by ``pads ((lo, hi) of H, (lo, hi) of
    W)``."""
    (hl, hh), (wl, wh) = pads
    if hl == hh == wl == wh == 0:
        return xc
    return F.pad(xc, (wl, wh, hl, hh), value=value)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding: Padding = "SAME") -> torch.Tensor:
    """2-D convolution of ``x (N, H, W, C)`` with ``w (kh, kw, C, O)``
    (cast to ``x``'s dtype), out ``(N, H', W', O)``; ``padding`` is
    ``"SAME"`` (XLA's), ``"VALID"`` or ``((lo, hi), (lo, hi))``."""
    pads = _pads(padding, x.shape[1:3], w.shape[:2], stride)
    xc = x.permute(0, 3, 1, 2)
    wc = w.to(x.dtype).permute(3, 2, 0, 1)
    (hl, hh), (wl, wh) = pads
    if hl == hh and wl == wh:
        y = F.conv2d(xc, wc, stride=stride, padding=(hl, wl))
    else:
        y = F.conv2d(_padded(xc, pads), wc, stride=stride)
    return y.permute(0, 2, 3, 1)


def max_pool_nhwc(x: torch.Tensor, window: int, stride: int,
                  padding: Padding = "SAME") -> torch.Tensor:
    """Max pool of ``x (N, H, W, C)`` over ``window x window`` at
    ``stride``, padded with ``-inf`` (XLA's ``reduce_window`` with
    ``lax.max`` from ``-inf``)."""
    pads = _pads(padding, x.shape[1:3], (window, window), stride)
    xc = _padded(x.permute(0, 3, 1, 2), pads, float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def he_init(generator: Optional[torch.Generator], shape: Sequence[int],
            dtype: torch.dtype, device=None) -> torch.Tensor:
    """Kaiming-normal HWIO conv weight: ``sqrt(2 / (kh * kw * C))`` times
    a standard normal drawn from ``generator``."""
    fan_in = shape[0] * shape[1] * shape[2]
    w = torch.empty(tuple(shape), dtype=dtype, device=device)
    with torch.no_grad():
        w.normal_(0.0, 1.0, generator=generator).mul_(math.sqrt(2.0 / fan_in))
    return w
