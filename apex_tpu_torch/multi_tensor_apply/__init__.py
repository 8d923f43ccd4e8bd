"""Multi-tensor operations over lists of tensors.

Counterpart of ``apex_tpu/multi_tensor_apply``, whose functions take a
pytree; here they take a list of tensors (non-floating entries pass
through) and keep JAX's results: ``(outputs, overflow)`` for scale and
axpby, the global norm (and a list of per-tensor norms) for the L2 norm.
JAX's are plain XLA; on CUDA tensors these launch the port's
multi-tensor kernels (``ops/multi_tensor.py``: one launch over the list,
the check of the incoming values in the same read), and on CPU tensors
their plain versions.  No host synchronisation.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import multi_tensor as mt

__all__ = [
    "MultiTensorApply",
    "global_l2norm",
    "multi_tensor_applier",
    "multi_tensor_axpby",
    "multi_tensor_l2norm",
    "multi_tensor_scale",
]

Scalar = Union[float, torch.Tensor]


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def multi_tensor_scale(tensors: Sequence[torch.Tensor], scale: Scalar,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``out = t * scale`` (fp32, rounded to ``out_dtype`` or t's dtype)
    for every floating tensor, and ``overflow``: True where an incoming
    value is not finite (a non-finite value the multiply makes does not
    count, as in the reference kernel)."""
    tensors = list(tensors)
    idx = [i for i, t in enumerate(tensors) if _is_float(t)]
    out = list(tensors)
    for i in idx:
        out[i] = torch.empty_like(tensors[i], dtype=out_dtype
                                  or tensors[i].dtype)
    if not idx:
        return out, torch.zeros((), dtype=torch.bool)
    finite = mt.scale([tensors[i] for i in idx], scale,
                      out=[out[i] for i in idx])
    return out, ~finite


def multi_tensor_axpby(a: Scalar, xs: Sequence[torch.Tensor], b: Scalar,
                       ys: Sequence[torch.Tensor],
                       out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``out = a * x + b * y`` pairwise (fp32, rounded to ``out_dtype`` or
    x's dtype), and ``overflow`` of the incoming x and y.  Every entry
    must be floating."""
    xs, ys = list(xs), list(ys)
    if len(xs) != len(ys):
        raise ValueError(f"{len(xs)} x tensors beside {len(ys)} y tensors")
    if not all(_is_float(t) for t in xs + ys):
        raise ValueError("multi_tensor_axpby takes floating tensors")
    out = [torch.empty_like(x, dtype=out_dtype or x.dtype) for x in xs]
    if not xs:
        return out, torch.zeros((), dtype=torch.bool)
    finite = mt.scale(xs, a, ys=ys, b=b, out=out)
    return out, ~finite


def multi_tensor_l2norm(tensors: Sequence[torch.Tensor],
                        per_tensor: bool = False):
    """The fp32 L2 norm of all floating tensors together (each one's sum
    of squares, their sum, one sqrt), and with ``per_tensor`` also the
    list of each one's norm: ``(total, [norms])``."""
    leaves = [t for t in tensors if _is_float(t)]
    norms = mt.l2norm(leaves, per_tensor=per_tensor)
    if not per_tensor:
        return norms.total
    return norms.total, list(norms.per_tensor.unbind()) if leaves else []


def global_l2norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`multi_tensor_l2norm`'s global norm: a 0-d fp32 tensor on the
    tensors' device."""
    return multi_tensor_l2norm(tensors, per_tensor=False)


class MultiTensorApply:
    """The reference dispatcher's shape: ``applier(op, noop_flag,
    tensor_lists, *args)`` calls ``op(tensor_lists, *args)``; the kernels
    chunk the lists themselves, so ``chunk_size`` is kept and not read."""

    available = True

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag_buffer, tensor_lists, *args):
        return op(tensor_lists, *args)


#: the JAX package's name for the dispatcher class
multi_tensor_applier = MultiTensorApply
