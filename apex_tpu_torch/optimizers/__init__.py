from apex_tpu_torch.optimizers.base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import FusedAdam

__all__ = ["FusedAdam", "FusedOptimizer"]
