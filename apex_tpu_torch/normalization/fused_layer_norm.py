"""The layer norm modules: the counterpart of
``apex_tpu/normalization/fused_layer_norm.py``.

- :class:`FusedLayerNorm`: ``elementwise_affine`` toggles the weight and
  bias; fp32 statistics, the output in the input's dtype;
- :class:`MixedFusedLayerNorm`: the output in the parameters' dtype
  (Megatron's mixed-dtype norm);
- :class:`FusedRMSNorm`: the RMS variant, a weight and no bias.

Each is an ``nn.Module`` over the functional entries of
:mod:`apex_tpu_torch.ops.layer_norm`, whose forward is the ``ln_fwd``
kernel and whose backward ``ln_bwd`` with ``ln_bwd_fold`` on the card
(the plain versions on the CPU).  The parameters take the shape of
``normalized_shape`` (an int or a tuple: the trailing dims normalized
together), ones and zeros of ``param_dtype``, as JAX's flax
initializers make them; ``device`` defaults to the GPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    mixed_dtype_fused_layer_norm_affine,
)
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["FusedLayerNorm", "MixedFusedLayerNorm", "FusedRMSNorm"]


def _shape_tuple(normalized_shape: Union[int, Sequence[int]]
                 ) -> Tuple[int, ...]:
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(int(s) for s in normalized_shape)


class _Norm(nn.Module):
    def __init__(self, normalized_shape, eps: float, affine: bool,
                 with_bias: bool, param_dtype: torch.dtype,
                 implementation: Optional[str], device):
        super().__init__()
        self.normalized_shape = _shape_tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = affine
        self.param_dtype = param_dtype
        self.implementation = implementation
        dev = resolve_device(device)
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)
        if affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=dev))
            if with_bias:
                self.bias = nn.Parameter(torch.zeros(
                    self.normalized_shape, dtype=param_dtype, device=dev))

    def extra_repr(self) -> str:
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}")


class FusedLayerNorm(_Norm):
    """Layer norm over the trailing ``normalized_shape`` dims."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 param_dtype: torch.dtype = torch.float32,
                 implementation: Optional[str] = None, *, device=None):
        super().__init__(normalized_shape, eps, elementwise_affine, True,
                         param_dtype, implementation, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.elementwise_affine:
            return fused_layer_norm(x, self.normalized_shape, self.eps,
                                    self.implementation)
        return fused_layer_norm_affine(x, self.weight, self.bias,
                                       self.normalized_shape, self.eps,
                                       self.implementation)


class MixedFusedLayerNorm(_Norm):
    """Layer norm whose output dtype is the parameters' even when the
    input's differs."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, param_dtype: torch.dtype = torch.float32,
                 implementation: Optional[str] = None, *, device=None):
        super().__init__(normalized_shape, eps, True, True, param_dtype,
                         implementation, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mixed_dtype_fused_layer_norm_affine(
            x, self.weight, self.bias, self.normalized_shape, self.eps,
            self.implementation)


class FusedRMSNorm(_Norm):
    """RMSNorm over the trailing ``normalized_shape`` dims (a weight, no
    bias)."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 param_dtype: torch.dtype = torch.float32,
                 implementation: Optional[str] = None, *, device=None):
        super().__init__(normalized_shape, eps, elementwise_affine, False,
                         param_dtype, implementation, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.elementwise_affine:
            return fused_rms_norm(x, self.normalized_shape, self.eps,
                                  self.implementation)
        return fused_rms_norm_affine(x, self.weight, self.normalized_shape,
                                     self.eps, self.implementation)
