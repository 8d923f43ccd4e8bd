"""Function-level cast decorators: the O1 "patch" as decorators.

Counterpart of ``apex_tpu/amp/functional.py`` (whose reference is Apex's
``amp.half_function`` and friends, ``apex/amp/amp.py:29-71``, and the cast
wrappers of ``apex/amp/wrap.py``): each decorator casts the floating
tensors among a function's arguments, nested in lists, tuples and dicts,
to a target dtype, then calls it.  ``half_function`` wrappers read the
process-global low-precision dtype at call time, so
:func:`set_low_precision_dtype` flips every one of them between fp16 (O1)
and bf16 (O4); it is bf16 until set, as in JAX.  A floating numpy array
among the arguments becomes a tensor of the target dtype, as JAX turns it
into an array of it; ``promote_function`` picks the widest dtype among the
tensors alone, as JAX's among its arrays.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = [
    "half_function",
    "bfloat16_function",
    "float_function",
    "promote_function",
    "register_half_function",
    "register_float_function",
    "register_promote_function",
    "set_low_precision_dtype",
]

# the process-global low-precision dtype; O1 uses fp16, O4 bf16
_LOW_PRECISION: Dict[str, torch.dtype] = {"dtype": torch.bfloat16}


def set_low_precision_dtype(dtype: torch.dtype) -> None:
    """Flip the dtype every ``half_function`` casts to (the O1 <-> O4
    move)."""
    _LOW_PRECISION["dtype"] = dtype


def _tensors(tree: Any) -> list:
    """The tensors of nested lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [t for v in tree for t in _tensors(v)]
    return []


def _cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, np.ndarray):
        return (torch.as_tensor(tree).to(dtype)
                if np.issubdtype(tree.dtype, np.floating) else tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, _cast_tree(v, dtype)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_cast_tree(v, dtype) for v in tree)
    return tree


def _wrap(fn: Callable, dtype_fn: Callable[[], torch.dtype]) -> Callable:
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        dtype = dtype_fn()
        return fn(*_cast_tree(args, dtype), **_cast_tree(kwargs, dtype))

    return wrapper


def half_function(fn: Callable) -> Callable:
    """Run in the low-precision dtype (fp16 under O1, bf16 under O4:
    :func:`set_low_precision_dtype`)."""
    return _wrap(fn, lambda: _LOW_PRECISION["dtype"])


def bfloat16_function(fn: Callable) -> Callable:
    """Run in bf16."""
    return _wrap(fn, lambda: torch.bfloat16)


def float_function(fn: Callable) -> Callable:
    """Always fp32: the blacklist."""
    return _wrap(fn, lambda: torch.float32)


def promote_function(fn: Callable) -> Callable:
    """Cast every floating argument to the widest floating dtype among
    them (``torch.promote_types``, as ``jnp.promote_types`` in JAX)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        dtypes = [x.dtype for x in _tensors((args, kwargs))
                  if x.is_floating_point()]
        if dtypes:
            widest = functools.reduce(torch.promote_types, dtypes)
            args, kwargs = _cast_tree(args, widest), _cast_tree(kwargs,
                                                                widest)
        return fn(*args, **kwargs)

    return wrapper


# module-level registration, as Apex's register_* API: the module's
# attribute is rebound to the decorated function
def _register(module: Any, name: str, deco: Callable) -> None:
    setattr(module, name, deco(getattr(module, name)))


def register_half_function(module: Any, name: str) -> None:
    _register(module, name, half_function)


def register_float_function(module: Any, name: str) -> None:
    _register(module, name, float_function)


def register_promote_function(module: Any, name: str) -> None:
    _register(module, name, promote_function)
