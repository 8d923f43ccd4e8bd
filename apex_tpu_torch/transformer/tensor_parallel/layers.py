"""Column/row-parallel linear, vocab-parallel embedding, quantized linear.

Counterparts of ``apex_tpu/transformer/tensor_parallel/layers.py`` as
``nn.Module``s over the tensor-parallel group of
:mod:`~apex_tpu_torch.transformer.parallel_state`, read when a layer is
built.  Weights keep the JAX layout ``(in, out)`` (embedding ``(vocab,
hidden)``).  JAX's ``init`` makes the full logical weight and its
placement shards it; here a layer draws the full weight from its
generator and keeps this rank's shard, so a layer built at any tp holds
the shard of the one built at tp = 1 from the same generator state.
Each layer describes how it shards as JAX's ``param_specs()`` does
(:meth:`param_specs`: a tuple per leaf naming the axis of each dim, or
None), which the weight carry (``apex_tpu_torch.convert``) reads, and
marks the parameters it shards ``tensor_model_parallel`` (with their
``partition_dim``), which ``clip_grad_norm`` reads.

- :class:`ColumnParallelLinear` shards the output features: the input
  goes through ``copy_to`` (its gradient is all-reduced), the output is
  this rank's shard, all-gathered with ``gather_output``;
- :class:`RowParallelLinear` shards the contraction: the input is
  scattered unless ``input_is_parallel``, the partial product goes
  through ``reduce_from``, THEN the replicated bias is added, once;
- :class:`VocabParallelEmbedding` shards the vocab: ids outside this
  rank's slice look up row 0 and are zeroed, then ``reduce_from``;
- :class:`QuantizedLinear` is a serving projection from a quantized
  weight pool (the JAX ``{"q8"|"q4", "scales", "bias"}`` leaf): its
  product is the dequant-matmul kernel, and with ``row_parallel`` the
  partial product is reduced before the bias, as JAX's ``_apply_linear``
  does.

At world size 1 every region is the identity and nothing is launched
for it.  The products go to ``torch.matmul``, as the JAX package leaves
them to XLA.  A weight is used once per call (cast to the input's dtype),
so autograd gives each weight one accumulated gradient in its own dtype;
the tied LM head adds its share to the embedding's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.dequant_matmul import dequant_matmul
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "QuantizedLinear",
           "VocabParallelEmbedding", "normal_init", "shard_dim", "shard"]

TP = parallel_state.TENSOR_PARALLEL_AXIS

#: ``init(tensor, generator)`` fills ``tensor`` in place
InitMethod = Callable[[torch.Tensor, Optional[torch.Generator]], None]
Spec = Tuple[Optional[str], ...]


def normal_init(std: float = 0.02) -> InitMethod:
    def init(t: torch.Tensor, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            t.normal_(0.0, std, generator=generator)

    return init


def shard_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards over the tensor-parallel axis, or None."""
    return spec.index(TP) if TP in spec else None


def shard(full: torch.Tensor, spec: Spec, tp: int,
          rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the full logical ``full`` under ``spec``
    (``full`` itself when the spec replicates it or ``tp`` is 1)."""
    dim = shard_dim(spec)
    if dim is None or tp == 1:
        return full
    n = full.shape[dim]
    if n % tp:
        raise ValueError(
            f"dim {dim} ({n}) must be divisible by the tensor-parallel "
            f"world size ({tp})")
    return full.narrow(dim, rank * (n // tp), n // tp).contiguous()


def _check_tp_divisible(value: int, what: str, tp: int) -> None:
    if value % tp != 0:
        raise ValueError(
            f"{what} ({value}) must be divisible by the tensor-parallel "
            f"world size ({tp})")


def _param(full: torch.Tensor, spec: Spec, tp: int,
           rank: int) -> nn.Parameter:
    p = nn.Parameter(shard(full, spec, tp, rank))
    dim = shard_dim(spec)
    p.tensor_model_parallel = dim is not None and tp > 1
    p.partition_dim = dim
    return p


class _Linear(nn.Module):
    #: the JAX ``param_specs()`` of the layer's leaves
    SPECS: Dict[str, Spec] = {}

    def __init__(self, input_size: int, output_size: int, *,
                 init_method: InitMethod, bias: bool = True,
                 params_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tp = parallel_state.get_tensor_model_parallel_world_size()
        self.rank = parallel_state.get_tensor_model_parallel_rank()
        self.input_size = input_size
        self.output_size = output_size
        full = torch.empty((input_size, output_size), dtype=params_dtype,
                           device=device)
        init_method(full, generator)
        self.weight = _param(full, self.SPECS["weight"], self.tp,
                             self.rank)
        if bias:
            # zero-init like the reference
            full = torch.zeros((output_size,), dtype=params_dtype,
                               device=device)
            self.bias = _param(full, self.SPECS["bias"], self.tp,
                               self.rank)
        else:
            self.register_parameter("bias", None)

    def param_specs(self) -> Dict[str, Spec]:
        return {k: v for k, v in self.SPECS.items()
                if getattr(self, k) is not None}

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.to(x.dtype))


class ColumnParallelLinear(_Linear):
    """``Y = XA + b`` with ``A (in, out)`` split along its output
    features; ``gather_output`` all-gathers ``Y`` (the JAX default), the
    GPT keeps its shard for a :class:`RowParallelLinear`."""

    SPECS = {"weight": (None, TP), "bias": (TP,)}

    def __init__(self, input_size: int, output_size: int, *,
                 gather_output: bool = True, **kwargs):
        tp = parallel_state.get_tensor_model_parallel_world_size()
        _check_tp_divisible(output_size,
                            "ColumnParallelLinear output_size", tp)
        super().__init__(input_size, output_size, **kwargs)
        self.gather_output = gather_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._product(copy_to_tensor_model_parallel_region(x))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.gather_output:
            y = gather_from_tensor_model_parallel_region(y)
        return y


class RowParallelLinear(_Linear):
    """``Y = XA + b`` with ``A (in, out)`` split along its input rows:
    the partial products are all-reduced and the replicated bias is
    added after the reduction."""

    SPECS = {"weight": (TP, None), "bias": (None,)}

    def __init__(self, input_size: int, output_size: int, *,
                 input_is_parallel: bool = False, **kwargs):
        tp = parallel_state.get_tensor_model_parallel_world_size()
        _check_tp_divisible(input_size, "RowParallelLinear input_size", tp)
        super().__init__(input_size, output_size, **kwargs)
        self.input_is_parallel = input_is_parallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x)
        y = reduce_from_tensor_model_parallel_region(self._product(x))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class QuantizedLinear(nn.Module):
    """``Y = x @ dequant(W) + b`` from a quantized weight pool, for
    serving (no gradients).  Buffers ``q8`` (int8 ``(in, out)``) or
    ``q4`` (packed int4 ``(in, out / 2)``), fp32 ``scales (in, out /
    block)`` and, where the full-width layer had one, ``bias``: the state
    dict of a quantized layer reads ``<name>.q8``, ``<name>.scales``,
    ``<name>.bias``, the keys the weight bridge makes of a JAX quantized
    leaf.  At tensor-parallel world size above 1 the buffers are this
    rank's shard: of the output features for a column-parallel leaf, of
    the contraction rows with ``row_parallel``, whose partial product is
    all-reduced before the bias is added.  The product and the bias add
    follow the JAX order: the dequant product comes back in x's dtype,
    then the bias is cast to it and added."""

    def __init__(self, weight_dtype: str, qweight: torch.Tensor,
                 scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 *, row_parallel: bool = False):
        super().__init__()
        if weight_dtype not in ("int8", "int4"):
            raise ValueError(
                f"weight_dtype must be 'int8' or 'int4', got "
                f"{weight_dtype!r}")
        self.weight_dtype = weight_dtype
        self.row_parallel = row_parallel
        self.qkey = "q8" if weight_dtype == "int8" else "q4"
        self.register_buffer(self.qkey, qweight)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @staticmethod
    def leaf_specs(qkey: str, row_parallel: bool) -> Dict[str, Spec]:
        """JAX ``_quantized_layer_specs`` of one unstacked leaf: a row
        leaf shards the contraction rows (its bias replicated), a column
        leaf the output features (its scale blocks and bias with
        them)."""
        w = (TP, None) if row_parallel else (None, TP)
        return {qkey: w, "scales": w,
                "bias": (None,) if row_parallel else (TP,)}

    def param_specs(self) -> Dict[str, Spec]:
        specs = self.leaf_specs(self.qkey, self.row_parallel)
        if self.bias is None:
            del specs["bias"]
        return specs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dequant_matmul(x, getattr(self, self.qkey), self.scales,
                           weight_dtype=self.weight_dtype)
        if self.row_parallel:
            y = reduce_from_tensor_model_parallel_region(y)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class VocabParallelEmbedding(nn.Module):
    """Token embedding table ``(vocab, hidden)`` sharded along the vocab:
    each rank looks up the ids in its slice, zeroes the others, and the
    partial embeddings are all-reduced (JAX's mask and ``psum``)."""

    SPECS = {"weight": (TP, None)}

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 init_method: InitMethod,
                 params_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tp = parallel_state.get_tensor_model_parallel_world_size()
        self.rank = parallel_state.get_tensor_model_parallel_rank()
        _check_tp_divisible(num_embeddings,
                            "VocabParallelEmbedding num_embeddings", self.tp)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        full = torch.empty((num_embeddings, embedding_dim),
                           dtype=params_dtype, device=device)
        init_method(full, generator)
        self.weight = _param(full, self.SPECS["weight"], self.tp, self.rank)

    def param_specs(self) -> Dict[str, Spec]:
        return dict(self.SPECS)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        if self.tp == 1:
            # the lookup's backward sums repeated ids in fp32 before
            # rounding to the weight's dtype
            return F.embedding(ids, self.weight)
        start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
            self.weight.shape[0], self.rank, self.tp)
        in_range = (ids >= start) & (ids < end)
        local = torch.where(in_range, ids - start, torch.zeros_like(ids))
        out = F.embedding(local, self.weight)
        out = torch.where(in_range[..., None], out, torch.zeros_like(out))
        return reduce_from_tensor_model_parallel_region(out)
