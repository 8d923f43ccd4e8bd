"""The whole-MLP module: the counterpart of ``apex_tpu/mlp``.

``sizes = [in, h1, ..., out]``: a linear layer (a weight ``(in, out)``,
JAX's layout, not ``nn.Linear``'s, and an optional bias) between each
pair, the activation between layers only.  JAX computes the stack in
XLA, outside any Pallas kernel, so the port's products are
``torch.matmul`` (cuBLAS on the card): no kernel is replaced here.

The layers are the module's children ``"0"``, ``"1"``, ..., so the state
dict names ``0.weight``, ``0.bias``, ... as JAX's list of ``{"weight",
"bias"}`` flattens (:func:`apex_tpu_torch.convert.layer_from_jax`).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import random as prng
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["MLP", "mlp_function"]

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
}


def mlp_function(params: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor,
                 activation: str = "relu") -> torch.Tensor:
    """Forward through the whole MLP: each weight (and bias) cast to the
    activation's dtype, the activation between layers only."""
    act = _ACTIVATIONS[activation]
    h = x
    last = len(params) - 1
    for i, layer in enumerate(params):
        h = torch.matmul(h, layer["weight"].to(h.dtype))
        if layer.get("bias") is not None:
            h = h + layer["bias"].to(h.dtype)
        if i != last:
            h = act(h)
    return h


def uniform(key, shape, bound: float, dtype: torch.dtype,
            device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, -bound, bound)``: JAX's
    values for fp32, the fp32 draw rounded to ``dtype`` otherwise."""
    return prng.uniform_range_tensor(key, shape, -bound, bound,
                                     device).to(dtype)


class _Linear(nn.Module):
    def __init__(self, key, fan_in: int, fan_out: int, bias: bool,
                 dtype: torch.dtype, device):
        super().__init__()
        kw, kb = prng.split(key)
        # kaiming uniform weights, uniform(1/sqrt(fan_in)) biases
        self.weight = nn.Parameter(uniform(
            kw, (fan_in, fan_out), math.sqrt(3.0 / fan_in), dtype, device))
        self.register_parameter("bias", None)
        if bias:
            self.bias = nn.Parameter(uniform(
                kb, (fan_out,), 1.0 / math.sqrt(fan_in), dtype, device))


class MLP(nn.Module):
    """N linear layers (+bias, +relu/sigmoid between them).  ``key`` (a
    port PRNG key, default ``PRNGKey(0)``) draws the weights as JAX's
    ``MLP.init(key)`` does; ``device`` defaults to the GPU."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu",
                 params_dtype: torch.dtype = torch.float32, *, device=None,
                 key=None):
        super().__init__()
        if len(mlp_sizes) < 2:
            raise TypeError(
                f"MLP requires at least two sizes (in, out); got {mlp_sizes}")
        if activation not in _ACTIVATIONS:
            raise TypeError(f"Activation type {activation} is not supported")
        self.mlp_sizes = list(mlp_sizes)
        self.use_bias = bias
        self.activation = activation
        self.params_dtype = params_dtype
        dev = resolve_device(device)
        keys = prng.split(prng.PRNGKey(0) if key is None else key,
                          len(self.mlp_sizes) - 1)
        for i, (k, fan_in, fan_out) in enumerate(
                zip(keys, self.mlp_sizes[:-1], self.mlp_sizes[1:])):
            self.add_module(str(i), _Linear(k, fan_in, fan_out, bias,
                                            params_dtype, dev))

    def layer_params(self):
        """The layers as JAX's list of ``{"weight"[, "bias"]}``."""
        return [{"weight": layer.weight, "bias": layer.bias}
                for layer in self.children()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_function(self.layer_params(), x, self.activation)
