"""Fused dense layers: the counterpart of ``apex_tpu/fused_dense``.

``y = x @ W + b`` and ``gelu(x @ W1 + b1) @ W2 + b2``, the weights
``(in, out)`` (JAX's layout), each cast to the input's dtype, and the
bias cast to the product's dtype before the add, as in JAX.  The GELU is
the tanh approximation (``jax.nn.gelu(approximate=True)``).  JAX leaves
the epilogue fusion to XLA, outside any Pallas kernel; the port's
products are ``torch.matmul`` (cuBLAS on the card) with PyTorch's
elementwise tail, so no kernel is replaced here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import random as prng
from apex_tpu_torch.mlp import uniform
from apex_tpu_torch.utils.platform import resolve_device

__all__ = [
    "fused_dense_function",
    "fused_dense_gelu_dense_function",
    "FusedDense",
    "FusedDenseGeluDense",
]


def fused_dense_function(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight + bias``, ``weight`` ``(in, out)``."""
    y = torch.matmul(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def fused_dense_gelu_dense_function(
    x: torch.Tensor,
    weight1: torch.Tensor,
    bias1: torch.Tensor,
    weight2: torch.Tensor,
    bias2: torch.Tensor,
) -> torch.Tensor:
    """``gelu_tanh(x @ W1 + b1) @ W2 + b2``."""
    h = F.gelu(fused_dense_function(x, weight1, bias1), approximate="tanh")
    return fused_dense_function(h, weight2, bias2)


def _init_wb(module: nn.Module, suffix: str, key, fan_in: int, fan_out: int,
             bias: bool, dtype: torch.dtype, device) -> None:
    kw, kb = prng.split(key)
    bound = 1.0 / math.sqrt(fan_in)
    module.register_parameter("weight" + suffix, nn.Parameter(
        uniform(kw, (fan_in, fan_out), bound, dtype, device)))
    module.register_parameter("bias" + suffix, nn.Parameter(
        uniform(kb, (fan_out,), bound, dtype, device)) if bias else None)


class FusedDense(nn.Module):
    """Linear + bias.  ``key`` (a port PRNG key, default ``PRNGKey(0)``)
    draws the parameters as JAX's ``FusedDense.init(key)``; ``device``
    defaults to the GPU."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 params_dtype: torch.dtype = torch.float32, *, device=None,
                 key=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        self.params_dtype = params_dtype
        _init_wb(self, "", prng.PRNGKey(0) if key is None else key,
                 in_features, out_features, bias, params_dtype,
                 resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense_function(x, self.weight, self.bias)


class FusedDenseGeluDense(nn.Module):
    """Linear + GELU + Linear; ``weight1``/``bias1``/``weight2``/``bias2``
    as JAX names them.  Without a bias it raises, as JAX's does."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, bias: bool = True,
                 params_dtype: torch.dtype = torch.float32, *, device=None,
                 key=None):
        super().__init__()
        if not bias:
            raise RuntimeError(
                "FusedDenseGeluDense module without bias is currently not "
                "supported")
        self.in_features = in_features
        self.intermediate_features = intermediate_features
        self.out_features = out_features
        self.params_dtype = params_dtype
        dev = resolve_device(device)
        k1, k2 = prng.split(prng.PRNGKey(0) if key is None else key)
        _init_wb(self, "1", k1, in_features, intermediate_features, True,
                 params_dtype, dev)
        _init_wb(self, "2", k2, intermediate_features, out_features, True,
                 params_dtype, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense_gelu_dense_function(
            x, self.weight1, self.bias1, self.weight2, self.bias2)
