"""SyncBatchNorm: batch normalization over the trailing feature axis.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py``, with its math
kept: fp32 sufficient statistics (count, sum of x, sum of x squared),
``var = E[x^2] - mean^2`` (biased) for the normalization, the output cast
to ``x``'s dtype before the optional ReLU, and the running variance
unbiased by ``count / max(count - 1, 1)``; eval mode normalizes with the
running statistics.  Plain PyTorch, as JAX's is XLA.

Across replicas JAX sums the statistics over the ``axis_name`` mesh axis
(within groups of ``process_group_size``).  The port runs one replica: at
data-parallel world size 1 that reduction is the identity, and more
than one replica (a ``torch.distributed`` world larger than one) raises,
naming ROADMAP.md queue A item 9.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["sync_batch_norm", "SyncBatchNorm"]


def _replicas() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _check_replicas(axis_name: Optional[str]) -> None:
    if axis_name is None:
        return
    world = _replicas()
    if world != 1:
        raise NotImplementedError(
            f"sync_batch_norm over {world} replicas of axis {axis_name!r}: "
            "only one replica is ported (ROADMAP.md queue A item 9)")


def _affine_out(x, xn, weight, bias, fuse_relu: bool) -> torch.Tensor:
    if weight is not None:
        xn = xn * weight.float()
    if bias is not None:
        xn = xn + bias.float()
    out = xn.to(x.dtype)
    return torch.relu(out) if fuse_relu else out


def sync_batch_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    running_mean: Optional[torch.Tensor],
    running_var: Optional[torch.Tensor],
    training: bool = True,
    momentum: float = 0.1,
    eps: float = 1e-5,
    axis_name: Optional[str] = None,
    process_group_size: int = 0,
    fuse_relu: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Batch norm of ``x (..., C)`` over every axis but the last.
    Returns ``(out, new_running_mean, new_running_var)``; the new
    statistics carry no gradient.  ``axis_name`` names the replicas to
    reduce over (one replica here; ``process_group_size`` then splits
    nothing)."""
    if not training:
        inv = torch.rsqrt(running_var.float() + eps)
        xn = (x.float() - running_mean.float()) * inv
        return (_affine_out(x, xn, weight, bias, fuse_relu), running_mean,
                running_var)
    _check_replicas(axis_name)
    feat = x.shape[-1]
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    count = np.float32(xf.numel() // feat)
    mean = xf.sum(dim=dims) / float(count)
    var = torch.square(xf).sum(dim=dims) / float(count) - torch.square(mean)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    out = _affine_out(x, xn, weight, bias, fuse_relu)
    new_rm, new_rv = running_mean, running_var
    if running_mean is not None:
        # the unbiasing factor in fp32, as JAX computes it
        unbias = float(count / np.maximum(count - np.float32(1.0),
                                          np.float32(1.0)))
        with torch.no_grad():
            new_rm = (1 - momentum) * running_mean + momentum * mean
            new_rv = (1 - momentum) * running_var + momentum * (var * unbias)
    return out, new_rm, new_rv


class SyncBatchNorm(nn.Module):
    """The module form (JAX's flax module): ``weight``/``bias``
    parameters (with ``affine``), ``running_mean``/``running_var`` fp32
    buffers (with ``track_running_stats``), updated by a training call.
    ``num_features`` None takes the channels of the first input (the
    parameters are made then)."""

    def __init__(self, num_features: Optional[int] = None, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = None,
                 process_group_size: int = 0, fuse_relu: bool = False,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.axis_name = axis_name
        self.process_group_size = process_group_size
        self.fuse_relu = fuse_relu
        self.param_dtype = param_dtype
        self.num_features = None
        self.register_parameter("weight", None)
        self.register_parameter("bias", None)
        self.register_buffer("running_mean", None)
        self.register_buffer("running_var", None)
        if num_features is not None:
            self._make(num_features, device)

    def _make(self, c: int, device) -> None:
        self.num_features = c
        if self.affine:
            self.weight = nn.Parameter(torch.ones(
                c, dtype=self.param_dtype, device=device))
            self.bias = nn.Parameter(torch.zeros(
                c, dtype=self.param_dtype, device=device))
        if self.track_running_stats:
            self.running_mean = torch.zeros(c, dtype=torch.float32,
                                            device=device)
            self.running_var = torch.ones(c, dtype=torch.float32,
                                          device=device)

    def forward(self, x: torch.Tensor,
                use_running_average: bool = False) -> torch.Tensor:
        if self.num_features is None:
            self._make(x.shape[-1], x.device)
        training = not use_running_average
        out, rm, rv = sync_batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            training=training, momentum=self.momentum, eps=self.eps,
            axis_name=self.axis_name,
            process_group_size=self.process_group_size,
            fuse_relu=self.fuse_relu)
        if training and self.track_running_stats:
            self.running_mean.copy_(rm)
            self.running_var.copy_(rv)
        return out
