"""The ResNet bottleneck block: the counterpart of
``apex_tpu/contrib/bottleneck``.

:class:`Bottleneck` is JAX's plain math, NHWC with HWIO weights: conv1x1
-> BN -> ReLU -> conv3x3 (the stride) -> BN -> ReLU -> conv1x1 -> BN,
the projection (conv1x1 at the stride, BN) where the stride or the
channels change, and ``relu(h + x)``.  Each BN normalizes with the
batch's own statistics (JAX's ``_bn``: training mode, no running
statistics), through :func:`apex_tpu_torch.parallel.sync_batch_norm`;
the convolutions are :func:`apex_tpu_torch.utils.convnet.conv_nhwc`
(cuDNN on the card, as JAX's are XLA's).  No kernel is replaced here.

:class:`SpatialBottleneck` and :func:`halo_exchange` shard the image
height over a ``cp`` mesh axis and trade halo rows between GPUs, which
is ROADMAP.md queue A item 9: they raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm
from apex_tpu_torch.utils.convnet import conv_nhwc, he_init
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["Bottleneck", "SpatialBottleneck", "halo_exchange"]

_ITEM_9 = ("shards the image height over the {!r} axis across GPUs: "
           "only one GPU is ported (ROADMAP.md queue A item 9)")


def _bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    out, _, _ = sync_batch_norm(x, scale, bias, None, None, training=True,
                                eps=eps)
    return out


class _BN(nn.Module):
    def __init__(self, c: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bn(x, self.scale, self.bias)


class Bottleneck(nn.Module):
    """conv1x1-BN-ReLU, conv3x3-BN-ReLU, conv1x1-BN, plus the input (or
    its projection), ReLU.  Parameters as JAX names them: ``conv1``..
    ``conv3`` and ``conv_proj`` (HWIO), ``bn1``..``bn3`` and ``bn_proj``
    (``scale``, ``bias``).  ``generator`` draws the He-normal weights;
    ``device`` defaults to the GPU."""

    expansion = 4

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1,
                 params_dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.bottleneck_channels = bottleneck_channels
        self.out_channels = out_channels
        self.stride = stride
        self.use_proj = stride != 1 or in_channels != out_channels
        self.params_dtype = params_dtype
        dev = resolve_device(device)
        c_in, c_mid, c_out = in_channels, bottleneck_channels, out_channels

        def conv(shape):
            return nn.Parameter(he_init(generator, shape, params_dtype, dev))

        self.conv1 = conv((1, 1, c_in, c_mid))
        self.bn1 = _BN(c_mid, params_dtype, dev)
        self.conv2 = conv((3, 3, c_mid, c_mid))
        self.bn2 = _BN(c_mid, params_dtype, dev)
        self.conv3 = conv((1, 1, c_mid, c_out))
        self.bn3 = _BN(c_out, params_dtype, dev)
        if self.use_proj:
            self.conv_proj = conv((1, 1, c_in, c_out))
            self.bn_proj = _BN(c_out, params_dtype, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(conv_nhwc(x, self.conv1)))
        h = F.relu(self.bn2(conv_nhwc(h, self.conv2, stride=self.stride)))
        h = self.bn3(conv_nhwc(h, self.conv3))
        if self.use_proj:
            x = self.bn_proj(conv_nhwc(x, self.conv_proj,
                                       stride=self.stride))
        return F.relu(h + x)


def halo_exchange(x: torch.Tensor, axis_name: str,
                  halo: int = 1) -> torch.Tensor:
    """JAX's halo rows from the spatial neighbours: raises (item 9)."""
    raise NotImplementedError("halo_exchange " + _ITEM_9.format(axis_name))


class SpatialBottleneck(Bottleneck):
    """JAX's height-sharded bottleneck: raises (item 9)."""

    def __init__(self, *args, axis_name: str = "cp", **kw):
        raise NotImplementedError(
            "SpatialBottleneck " + _ITEM_9.format(axis_name))
