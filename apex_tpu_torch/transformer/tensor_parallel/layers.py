"""Column/row-parallel linear and vocab-parallel embedding at world size 1.

Counterparts of ``apex_tpu/transformer/tensor_parallel/layers.py`` as
``nn.Module``s.  Weights keep the JAX layout ``(in, out)`` (embedding
``(vocab, hidden)``), so carrying weights across is a copy
(``apex_tpu_torch.convert``).  The products go to ``torch.matmul``, as
the JAX package leaves them to XLA.  A weight is used once per call
(cast to the input's dtype, a no-op when they match), so autograd gives
each weight one accumulated gradient in its own dtype; the tied LM head
adds its share to the embedding's.  At world size 1 the collectives of
the JAX layers are identities; sharding over ``torch.distributed`` is
ROADMAP.md queue A item 9.

:class:`QuantizedLinear` is a serving projection from a quantized weight
pool (the JAX ``{"q8"|"q4", "scales", "bias"}`` leaf of
``quantize_gpt_weights``): its product goes to the dequant-matmul kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.dequant_matmul import dequant_matmul
from apex_tpu_torch.transformer import parallel_state

__all__ = ["ColumnParallelLinear", "RowParallelLinear", "QuantizedLinear",
           "VocabParallelEmbedding", "normal_init"]

#: ``init(tensor, generator)`` fills ``tensor`` in place
InitMethod = Callable[[torch.Tensor, Optional[torch.Generator]], None]


def normal_init(std: float = 0.02) -> InitMethod:
    def init(t: torch.Tensor, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            t.normal_(0.0, std, generator=generator)

    return init


def _check_world_size(what: str) -> None:
    world = parallel_state.get_tensor_model_parallel_world_size()
    if world != 1:
        raise NotImplementedError(
            f"{what} at tensor-parallel world size {world}: only world "
            "size 1 is ported (ROADMAP.md queue A item 9)")


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, *,
                 init_method: InitMethod, bias: bool = True,
                 params_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_world_size(type(self).__name__)
        self.input_size = input_size
        self.output_size = output_size
        self.weight = nn.Parameter(torch.empty(
            (input_size, output_size), dtype=params_dtype, device=device))
        init_method(self.weight, generator)
        if bias:
            # zero-init like the reference
            self.bias = nn.Parameter(torch.zeros(
                (output_size,), dtype=params_dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ColumnParallelLinear(_Linear):
    """``Y = XA + b`` with ``A`` of shape ``(in, out)``; at world size 1
    the output is already whole."""


class RowParallelLinear(_Linear):
    """``Y = XA + b`` with ``A`` of shape ``(in, out)``; at world size 1
    there is no partial sum to reduce."""


class QuantizedLinear(nn.Module):
    """``Y = x @ dequant(W) + b`` from a quantized weight pool, for
    serving (no gradients).  Buffers ``q8`` (int8 ``(in, out)``) or
    ``q4`` (packed int4 ``(in, out / 2)``), fp32 ``scales (in, out /
    block)`` and, where the full-width layer had one, ``bias``: the state
    dict of a quantized layer reads ``<name>.q8``, ``<name>.scales``,
    ``<name>.bias``, the keys the weight bridge makes of a JAX quantized
    leaf.  The product and the bias add follow the JAX order: the
    dequant product comes back in x's dtype, then the bias is cast to it
    and added."""

    def __init__(self, weight_dtype: str, qweight: torch.Tensor,
                 scales: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        if weight_dtype not in ("int8", "int4"):
            raise ValueError(
                f"weight_dtype must be 'int8' or 'int4', got "
                f"{weight_dtype!r}")
        self.weight_dtype = weight_dtype
        self.qkey = "q8" if weight_dtype == "int8" else "q4"
        self.register_buffer(self.qkey, qweight)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dequant_matmul(x, getattr(self, self.qkey), self.scales,
                           weight_dtype=self.weight_dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class VocabParallelEmbedding(nn.Module):
    """Token embedding table ``(vocab, hidden)``; at world size 1 every id
    falls in the local vocab range."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 init_method: InitMethod,
                 params_dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_world_size("VocabParallelEmbedding")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), dtype=params_dtype,
            device=device))
        init_method(self.weight, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # the lookup's backward sums repeated ids in fp32 before rounding
        # to the weight's dtype
        return F.embedding(ids.long(), self.weight)
