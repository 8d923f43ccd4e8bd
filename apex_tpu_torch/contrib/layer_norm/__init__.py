"""FastLayerNorm: the counterpart of ``apex_tpu/contrib/layer_norm``.

JAX's contrib name re-exports its normalization stack, as the fast and
the standard fused layer norm are one Pallas kernel there.  So here:
:class:`FastLayerNorm` is :class:`~apex_tpu_torch.normalization.
FusedLayerNorm` and :func:`fast_layer_norm` is
:func:`~apex_tpu_torch.ops.layer_norm.fused_layer_norm_affine`, the
``ln_fwd``/``ln_bwd`` kernels, with no restriction on the hidden size
beyond the kernel's own.
"""

from apex_tpu_torch.normalization import FusedLayerNorm as FastLayerNorm
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm_affine as fast_layer_norm,
)

__all__ = ["FastLayerNorm", "fast_layer_norm"]
