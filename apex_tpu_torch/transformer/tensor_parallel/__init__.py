from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    lm_head_cross_entropy,
    vocab_parallel_cross_entropy,
    vocab_parallel_cross_entropy_from_hidden,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    QuantizedLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    normal_init,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import clip_grad_norm

__all__ = ["ColumnParallelLinear", "QuantizedLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "clip_grad_norm",
           "lm_head_cross_entropy", "normal_init",
           "vocab_parallel_cross_entropy",
           "vocab_parallel_cross_entropy_from_hidden"]
