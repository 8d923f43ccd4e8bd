"""The fused optimizers as ``torch.optim.Optimizer``s (counterpart of
``apex_tpu/optimizers``): fp32 master weights (``master_weights=True``),
the overflow skip-step (``step(grads_finite=)``, ``step_scaled``) and, for
FusedAdam and FusedLAMB, the multi-tensor kernels and the packed fused
tail (``fused_tail=True``)."""

from apex_tpu_torch.optimizers.base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD
from apex_tpu_torch.optimizers.larc import LARC, larc_transform

__all__ = ["FusedAdagrad", "FusedAdam", "FusedLAMB",
           "FusedMixedPrecisionLamb", "FusedNovoGrad", "FusedOptimizer",
           "FusedSGD", "LARC", "larc_transform"]
