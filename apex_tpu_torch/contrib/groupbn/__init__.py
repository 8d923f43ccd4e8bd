"""Group BatchNorm, NHWC, with the fused residual add and ReLU: the
counterpart of ``apex_tpu/contrib/groupbn``.

Over :func:`apex_tpu_torch.parallel.sync_batch_norm` (JAX's is over its
own ``sync_batch_norm``): the batch norm of the channels-last ``x``,
then ``+ z`` (the residual, cast to the output's dtype) and the ReLU.
JAX shares the statistics among groups of ``bn_group`` data-parallel
ranks; the port runs one rank, so ``bn_group > 1`` raises, naming
ROADMAP.md queue A item 9, as ``sync_batch_norm`` does over more than one
replica.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm
from apex_tpu_torch.transformer.parallel_state import DATA_PARALLEL_AXIS
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["BatchNorm2d_NHWC", "batch_norm_nhwc"]


def _check_group(bn_group: int) -> None:
    if bn_group > 1:
        raise NotImplementedError(
            f"bn_group={bn_group} shares statistics among {bn_group} "
            "data-parallel ranks: only one rank is ported (ROADMAP.md "
            "queue A item 9)")


def batch_norm_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: Optional[torch.Tensor] = None,
    running_var: Optional[torch.Tensor] = None,
    *,
    z: Optional[torch.Tensor] = None,
    training: bool = True,
    momentum: float = 0.1,
    eps: float = 1e-5,
    bn_group: int = 1,
    axis_name: Optional[str] = DATA_PARALLEL_AXIS,
    fuse_relu: bool = False,
):
    """NHWC batch norm, then ``+ z`` and the ReLU where asked.  Returns
    ``(out, new_running_mean, new_running_var)``."""
    _check_group(bn_group)
    out, rm, rv = sync_batch_norm(
        x, weight, bias, running_mean, running_var, training=training,
        momentum=momentum, eps=eps,
        axis_name=axis_name if bn_group != 1 else None,
        process_group_size=0, fuse_relu=False)
    if z is not None:
        out = out + z.to(out.dtype)
    if fuse_relu:
        out = torch.relu(out)
    return out, rm, rv


class BatchNorm2d_NHWC(nn.Module):
    """The module form: ``weight``/``bias`` parameters of
    ``params_dtype`` (ones and zeros) and fp32 ``running_mean``/
    ``running_var`` buffers, which a call in training mode updates in
    place (JAX returns the new statistics in new params)."""

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, momentum: float = 0.1, eps: float = 1e-5,
                 params_dtype: torch.dtype = torch.float32,
                 axis_name: str = DATA_PARALLEL_AXIS, *, device=None):
        super().__init__()
        _check_group(bn_group)
        self.num_features = num_features
        self.fuse_relu = fuse_relu
        self.bn_group = bn_group
        self.momentum = momentum
        self.eps = eps
        self.params_dtype = params_dtype
        self.axis_name = axis_name
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(num_features,
                                              dtype=params_dtype, device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features,
                                             dtype=params_dtype, device=dev))
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x: torch.Tensor,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        out, rm, rv = batch_norm_nhwc(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            z=z, training=self.training, momentum=self.momentum,
            eps=self.eps, bn_group=self.bn_group, axis_name=self.axis_name,
            fuse_relu=self.fuse_relu)
        if self.training:
            self.running_mean.copy_(rm)
            self.running_var.copy_(rv)
        return out
