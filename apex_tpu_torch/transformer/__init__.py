from apex_tpu_torch.transformer import (
    enums,
    functional,
    parallel_state,
    tensor_parallel,
    utils,
)
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = ["AttnMaskType", "enums", "functional", "parallel_state",
           "tensor_parallel", "utils"]
