from apex_tpu_torch.telemetry.spans import PHASE_PREFIX, phase

__all__ = ["phase", "PHASE_PREFIX"]
