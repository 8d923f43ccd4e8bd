"""Tensor parallelism (Megatron TP) over ``torch.distributed``: the
regions, the parallel layers, the vocab-parallel cross entropy, the
per-rank PRNG keys and the model-parallel gradient clip.  Counterpart of
``apex_tpu/transformer/tensor_parallel``; the JAX ``checkpoint`` (remat
with the PRNG) and ``state_specs_like`` (shard_map specs of optimizer
state) have no counterpart: the port remats with
``torch.utils.checkpoint`` and each rank's optimizer holds its own
shards."""

from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_gather_invariant,
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    lm_head_cross_entropy,
    vocab_parallel_cross_entropy,
    vocab_parallel_cross_entropy_from_hidden,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    QuantizedLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    normal_init,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    data_parallel_key,
    model_parallel_key,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    clip_grad_norm,
    split_tensor_along_last_dim,
)

__all__ = ["ColumnParallelLinear", "QuantizedLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "VocabUtility", "all_gather_invariant",
           "broadcast_data", "clip_grad_norm",
           "copy_to_tensor_model_parallel_region", "data_parallel_key",
           "gather_from_tensor_model_parallel_region",
           "lm_head_cross_entropy", "model_parallel_key", "normal_init",
           "reduce_from_tensor_model_parallel_region",
           "scatter_to_tensor_model_parallel_region",
           "split_tensor_along_last_dim", "vocab_parallel_cross_entropy",
           "vocab_parallel_cross_entropy_from_hidden"]
