"""FusedMixedPrecisionLamb: LAMB with fp32 masters and low-precision
model parameters in one step.

Counterpart of ``apex_tpu/optimizers/fused_mixed_precision_lamb.py``: it
is :class:`~apex_tpu_torch.optimizers.fused_lamb.FusedLAMB` with
``master_weights=True``, whose ``multi_tensor_lamb`` launch updates the
fp32 master and writes the model-dtype parameter in the same pass.
"""

from __future__ import annotations

from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedMixedPrecisionLamb"]


class FusedMixedPrecisionLamb(FusedLAMB):
    def __init__(self, *args, **kwargs):
        kwargs["master_weights"] = True
        super().__init__(*args, **kwargs)
