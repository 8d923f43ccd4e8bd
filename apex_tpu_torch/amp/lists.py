"""Curated cast lists: the numerics knowledge of Apex's amp O1.

Counterpart of ``apex_tpu/amp/lists.py``, which carries Apex's
classification of ops (``apex/amp/lists/torch_overrides.py:7-47``,
``functional_overrides.py:18-40``, ``tensor_overrides.py``) over
``jax.numpy`` / ``jax.nn`` / ``jax.lax``: low-precision-safe (the matrix
products and convolutions), fp32-required (transcendentals, powers,
reductions, softmax and norms) and dtype-promoting (multi-operand ops).
Here the same classification is mapped back onto ``torch`` and
``torch.nn.functional`` and applied through the decorators of
:mod:`apex_tpu_torch.amp.functional`.

The JAX entries and their torch twins, list by list:

- ``LOW_PRECISION_NUMPY`` (``torch``): matmul, dot, vdot, inner, outer,
  tensordot, einsum: each has a twin of its name.
- ``LOW_PRECISION_LAX`` (``torch.nn.functional``): ``lax.dot`` ->
  ``linear``; ``lax.conv``, ``conv_general_dilated`` and
  ``conv_with_general_padding`` -> ``conv1d``/``conv2d``/``conv3d`` (which
  take the dilation and padding); ``lax.conv_transpose`` ->
  ``conv_transpose1d``/``2d``/``3d``.  ``lax.dot_general`` has no twin of
  its own (``torch.tensordot`` and ``torch.einsum``, in the list above,
  cover it).
- ``FP32_NUMPY`` (``torch``): every entry has a twin of its name but
  ``power`` -> ``pow``; ``jax.nn.logsumexp`` is here as ``logsumexp``,
  which torch keeps outside ``torch.nn.functional``.
- ``FP32_NN`` (``torch.nn.functional``): softmax, log_softmax;
  ``jax.nn.standardize`` -> ``layer_norm`` (the normalisation over the
  last dims, in Apex's fp32 functional list too).
- ``PROMOTE_NUMPY`` and ``SEQUENCE_NUMPY`` (``torch``): every entry has a
  twin of its name.  Torch promotes these natively, as ``jnp`` does, so
  their wrappers change no result; they are kept as in JAX.

Two application modes:

- :func:`cast_namespaces` -- proxy namespaces (``.torch`` and
  ``.functional``, for JAX's ``.numpy`` and ``.nn`` / ``.lax``) whose
  listed functions are wrapped; everything else passes through.  No
  global state is touched::

      ns = cast_namespaces()
      y = ns.torch.matmul(a, b)          # runs in the low-precision dtype
      p = ns.functional.softmax(x, -1)   # always fp32

- :func:`patch` -- Apex's O1 form: rebinds the listed functions of the
  real ``torch`` and ``torch.nn.functional`` in place and returns a
  handle whose ``restore()`` (or the end of its ``with`` block) puts back
  every original.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.amp.functional import (
    float_function,
    half_function,
    promote_function,
)

__all__ = [
    "LOW_PRECISION_NUMPY",
    "LOW_PRECISION_LAX",
    "FP32_NUMPY",
    "FP32_NN",
    "PROMOTE_NUMPY",
    "SEQUENCE_NUMPY",
    "cast_namespaces",
    "patch",
]

# low-precision-safe: the matrix products and convolutions
# (torch_overrides.py:7-25)
LOW_PRECISION_NUMPY: List[str] = [
    "matmul", "dot", "vdot", "inner", "outer", "tensordot", "einsum",
]

LOW_PRECISION_LAX: List[str] = [
    "linear", "conv1d", "conv2d", "conv3d",
    "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
]

# fp32-required: transcendentals, powers, reductions and normalisations
# (torch_overrides.py:27-47; functional_overrides.py:18-40)
FP32_NUMPY: List[str] = [
    "arccos", "arcsin", "arctan", "cosh", "sinh", "tan",
    "exp", "expm1", "log", "log10", "log1p", "log2",
    "pow", "float_power", "reciprocal",
    "sum", "prod", "cumsum", "cumprod", "mean", "std", "var",
    "logsumexp",
]

FP32_NN: List[str] = [
    "softmax", "log_softmax", "layer_norm",
]

# multi-operand ops Apex promotes explicitly (tensor_overrides.py CASTS /
# SEQUENCE_CASTS)
PROMOTE_NUMPY: List[str] = [
    "add", "subtract", "multiply", "divide", "true_divide",
    "arctan2", "cross", "hypot", "maximum", "minimum",
]

SEQUENCE_NUMPY: List[str] = ["concatenate", "stack", "hstack", "vstack"]


_PLAN: List[Tuple[Any, List[str], Callable]] = [
    (torch, LOW_PRECISION_NUMPY, half_function),
    (F, LOW_PRECISION_LAX, half_function),
    (torch, FP32_NUMPY, float_function),
    (F, FP32_NN, float_function),
    (torch, PROMOTE_NUMPY, promote_function),
    (torch, SEQUENCE_NUMPY, promote_function),
]


class _CastNamespace:
    """Attribute proxy: listed names are wrapped, the rest pass through."""

    def __init__(self, module: Any, overrides: Dict[str, Callable]):
        self._module = module
        self._overrides = overrides

    def __getattr__(self, name: str):
        try:
            return self._overrides[name]
        except KeyError:
            return getattr(self._module, name)


def _overrides_for(module: Any) -> Dict[str, Callable]:
    out: Dict[str, Callable] = {}
    for mod, names, deco in _PLAN:
        if mod is not module:
            continue
        for name in names:
            fn = getattr(module, name, None)
            if fn is not None:
                out[name] = deco(fn)
    return out


def cast_namespaces() -> SimpleNamespace:
    """Proxy namespaces with the cast lists applied (no global mutation):
    ``torch`` and ``functional`` (``torch.nn.functional``).
    ``half``-class wrappers follow the process low-precision dtype, so
    :func:`apex_tpu_torch.amp.set_low_precision_dtype` flips them between
    fp16 (O1) and bf16 (O4)."""
    return SimpleNamespace(torch=_CastNamespace(torch, _overrides_for(torch)),
                           functional=_CastNamespace(F, _overrides_for(F)))


class _PatchHandle:
    def __init__(self, saved: List[Tuple[Any, str, Callable]]):
        self._saved = saved

    def restore(self) -> None:
        # in reverse, so a name listed twice gets its first original back
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()
        return False


def patch() -> _PatchHandle:
    """Apply the cast lists to the real ``torch`` and
    ``torch.nn.functional`` (Apex's O1 patch, ``apex/amp/amp.py:75-198``)
    and return a context-manager handle that restores the originals."""
    saved: List[Tuple[Any, str, Callable]] = []
    for mod, names, deco in _PLAN:
        for name in names:
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            saved.append((mod, name, fn))
            setattr(mod, name, deco(fn))
    return _PatchHandle(saved)
