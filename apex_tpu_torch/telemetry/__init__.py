from apex_tpu_torch.telemetry.metrics import (
    device_peak_flops,
    mfu,
    transformer_flops_per_token,
)
from apex_tpu_torch.telemetry.spans import PHASE_PREFIX, phase

__all__ = ["PHASE_PREFIX", "device_peak_flops", "mfu", "phase",
           "transformer_flops_per_token"]
