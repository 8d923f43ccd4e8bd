"""The fused layer norm family: the counterpart of
``apex_tpu/normalization``.

The functional forms are :mod:`apex_tpu_torch.ops.layer_norm`'s entries
(the ``ln_fwd``/``ln_bwd`` kernels on the card, their plain versions on
the CPU), re-exported as JAX's package re-exports its own; the modules
are :mod:`apex_tpu_torch.normalization.fused_layer_norm`'s.  The
package's ``fused_layer_norm`` is the function (in JAX's package the
submodule's import shadows it).
"""

# the submodule first: importing it binds its name on the package, which
# the function of the same name imported after it takes back
from apex_tpu_torch.normalization.fused_layer_norm import (  # noqa: F401
    FusedLayerNorm,
    MixedFusedLayerNorm,
    FusedRMSNorm,
)
from apex_tpu_torch.ops.layer_norm import (  # noqa: F401
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    mixed_dtype_fused_layer_norm_affine,
)

__all__ = [
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "fused_rms_norm",
    "fused_rms_norm_affine",
    "mixed_dtype_fused_layer_norm_affine",
    "FusedLayerNorm",
    "MixedFusedLayerNorm",
    "FusedRMSNorm",
]
