"""Weight-norm reparameterization: the counterpart of
``apex_tpu/reparameterization``.

``w = g * v / ||v||``, the norm over every dim but ``dim`` (all of them
for ``dim=None``), as a pair of converters on tensors: call
:func:`compute_weight` in the forward, no hooks.  Norms are taken in
fp32 and floored at 1e-12, and the weight is cast to ``v``'s dtype.
:func:`apply_weight_norm` turns each ``name`` entry of a state dict
(``"fc.weight"``: the last dotted part is the name) or of a nested dict
or list of tensors into ``{"g", "v"}``, as JAX's pytree walk does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = ["weight_norm_init", "compute_weight", "remove_weight_norm",
           "apply_weight_norm"]


def _norm_except(v: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``||v||`` in fp32 over every dim except ``dim``, kept as size 1."""
    dims = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(v.float()), dim=dims,
                                keepdim=True))


def weight_norm_init(weight: torch.Tensor,
                     dim: Optional[int] = 0) -> Dict[str, torch.Tensor]:
    """Split a weight into the ``{"g", "v"}`` parameterization."""
    return {"g": _norm_except(weight, dim).to(weight.dtype), "v": weight}


def compute_weight(wn: Dict[str, torch.Tensor],
                   dim: Optional[int] = 0) -> torch.Tensor:
    """``g * v / max(||v||, 1e-12)`` in fp32, cast to ``v``'s dtype."""
    v = wn["v"]
    norm = _norm_except(v, dim)
    w = wn["g"].float() * v.float() / torch.clamp_min(norm, 1e-12)
    return w.to(v.dtype)


def remove_weight_norm(wn: Dict[str, torch.Tensor],
                       dim: Optional[int] = 0) -> torch.Tensor:
    """Collapse ``{"g", "v"}`` back to a plain weight."""
    return compute_weight(wn, dim)


def apply_weight_norm(params: Any, name: str = "weight",
                      dim: Optional[int] = 0) -> Any:
    """Every tensor entry named ``name`` of ``params`` (a state dict, or
    nested dicts and lists of tensors) in the ``{"g", "v"}`` form; the
    rest as it is.  Returns a new container; the tensors are not
    copied."""

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, None) for v in node)
        if (isinstance(node, torch.Tensor) and key is not None
                and key.rsplit(".", 1)[-1] == name):
            return weight_norm_init(node, dim)
        return node

    return walk(params, None)
