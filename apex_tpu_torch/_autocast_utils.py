"""Ambient precision for the fused modules.

Counterpart of ``apex_tpu/_autocast_utils.py`` (after Apex's
``apex/_autocast_utils.py``, ``_cast_if_autocast_enabled``): a thread-local
compute dtype that :func:`autocast` installs and
:func:`_cast_if_autocast_enabled` consults, so a module can cast its
floating inputs to it.  Explicit, as in JAX: ``torch.autocast`` is not
read or touched.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

import torch

__all__ = ["autocast", "get_autocast_dtype", "_cast_if_autocast_enabled"]

_STATE = threading.local()


def get_autocast_dtype() -> Optional[torch.dtype]:
    """The dtype :func:`autocast` installed on this thread, or None."""
    return getattr(_STATE, "dtype", None)


@contextlib.contextmanager
def autocast(dtype: torch.dtype = torch.bfloat16, enabled: bool = True):
    """``with apex_tpu_torch._autocast_utils.autocast(torch.float16):``
    -- modules called inside cast their floating inputs to ``dtype``
    (``enabled=False`` turns an outer one off)."""
    prev = get_autocast_dtype()
    _STATE.dtype = dtype if enabled else None
    try:
        yield
    finally:
        _STATE.dtype = prev


def _cast_if_autocast_enabled(*args: Any) -> Sequence[Any]:
    """``args`` with every floating tensor cast to the autocast dtype,
    when one is installed; as given otherwise."""
    dtype = get_autocast_dtype()
    if dtype is None:
        return args
    return tuple(
        a.to(dtype) if isinstance(a, torch.Tensor) and a.is_floating_point()
        else a
        for a in args)
