from apex_tpu_torch.amp.policy import (
    OPT_LEVELS,
    Policy,
    check_ported,
    get_policy,
)

__all__ = ["OPT_LEVELS", "Policy", "check_ported", "get_policy"]
