"""Model-parallel state at world size 1.

``apex_tpu/transformer/parallel_state.py`` builds a 4-D JAX mesh.  The
port serves on one GPU so far, so this is the world-size-1 stub the
layers need: world-size getters that always answer one and rank getters
that always answer zero (the JAX ``axis_index`` of a one-device mesh).
Tensor parallelism over ``torch.distributed`` is ROADMAP.md queue A
item 9.
"""

from __future__ import annotations

__all__ = ["get_tensor_model_parallel_world_size",
           "get_tensor_model_parallel_rank", "get_data_parallel_rank",
           "DATA_PARALLEL_AXIS", "PIPELINE_PARALLEL_AXIS",
           "TENSOR_PARALLEL_AXIS"]

#: the JAX mesh's axis names, which the model-parallel scaler takes
DATA_PARALLEL_AXIS = "dp"
PIPELINE_PARALLEL_AXIS = "pp"
TENSOR_PARALLEL_AXIS = "tp"


def get_tensor_model_parallel_world_size() -> int:
    return 1


def get_tensor_model_parallel_rank() -> int:
    return 0


def get_data_parallel_rank() -> int:
    return 0
