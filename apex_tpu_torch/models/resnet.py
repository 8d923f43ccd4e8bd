"""ResNet (18/34/50/101/152), the imagenet model family, trained on one GPU.

Counterpart of ``apex_tpu/models/resnet.py``: NHWC activations, HWIO
conv weights, batch norm with fp32 statistics, bf16 compute by default
and an fp32 mean pool and ``fc``.  The JAX model is functional
(``init(key) -> (params, batch_stats)``, ``apply(params, batch_stats, x,
training) -> (logits, new_batch_stats)``); here it is an ``nn.Module``
whose parameters and buffers carry the JAX trees' names (``conv_stem``,
``bn_stem.{scale, bias, mean, var}``, ``stages.<s>.<b>.{conv1, bn1, ...,
conv_proj, bn_proj}``, ``fc.{weight, bias}``), so
``apex_tpu_torch.convert.resnet_from_jax`` / ``resnet_to_jax`` carry both
trees across.  :meth:`ResNet.apply` keeps the functional entry over such
trees (the module's own by default); ``forward`` runs it on the module's
parameters and writes a training call's new statistics into the buffers.

Kept from JAX: the zero-initialised last norm scale of each block, the
policy's ``keep_norm_fp32``, the stride-2 convolutions' and the max
pool's ``"SAME"`` padding (XLA's asymmetric pads, ``utils.convnet``), the
max pool padded with ``-inf``, and statistics summed over the
data-parallel axis (``sync_bn_axis``, one replica in the port).  The
convolutions are cuDNN's (``F.conv2d``), as JAX's are XLA's: no Pallas
kernel is on this path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch.amp.policy import Policy, check_ported
from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm
from apex_tpu_torch.transformer.parallel_state import DATA_PARALLEL_AXIS
from apex_tpu_torch.utils.convnet import conv_nhwc, he_init, max_pool_nhwc
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["ResNetConfig", "ResNet", "resnet50"]

_DEPTHS = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}


@dataclasses.dataclass
class ResNetConfig:
    """Hyperparameters, as in the JAX package's ``ResNetConfig``:
    ``policy`` overrides the two dtypes and keeps the norms' parameters
    fp32 when it says so; ``sync_bn_axis`` None normalizes over the local
    batch, ``"dp"`` over the data-parallel replicas (one here)."""

    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    policy: Optional[Policy] = None
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    sync_bn_axis: Optional[str] = DATA_PARALLEL_AXIS

    def __post_init__(self):
        if self.policy is not None:
            check_ported(self.policy)
            self.params_dtype = self.policy.param_dtype
            self.compute_dtype = self.policy.compute_dtype
        if self.depth not in _DEPTHS:
            raise ValueError(f"unsupported depth {self.depth}")
        self.stage_blocks, self.bottleneck = _DEPTHS[self.depth]

    @property
    def norm_dtype(self) -> torch.dtype:
        if self.policy is not None and self.policy.keep_norm_fp32:
            return torch.float32
        return self.params_dtype


class BatchNorm(nn.Module):
    """One norm's ``scale``/``bias`` parameters and ``mean``/``var`` fp32
    buffers (the JAX ``params`` and ``batch_stats`` leaves)."""

    def __init__(self, c: int, dtype: torch.dtype, device,
                 zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.full(
            (c,), 0.0 if zero_scale else 1.0, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype, device=device))
        self.register_buffer("mean", torch.zeros(c, dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(c, dtype=torch.float32,
                                               device=device))

    def params(self) -> Dict[str, torch.Tensor]:
        return {"scale": self.scale, "bias": self.bias}

    def stats(self) -> Dict[str, torch.Tensor]:
        return {"mean": self.mean, "var": self.var}


class Block(nn.Module):
    """A basic (two 3x3 convs) or bottleneck (1x1, 3x3, 1x1) block, with
    a projection where the stride or the width changes."""

    def __init__(self, c: ResNetConfig, c_in: int, c_mid: int, c_out: int,
                 stride: int, device, generator):
        super().__init__()
        if c.bottleneck:
            shapes = [(1, 1, c_in, c_mid), (3, 3, c_mid, c_mid),
                      (1, 1, c_mid, c_out)]
        else:
            shapes = [(3, 3, c_in, c_mid), (3, 3, c_mid, c_out)]
        self.convs = [f"conv{i + 1}" for i in range(len(shapes))]
        for i, shape in enumerate(shapes):
            setattr(self, f"conv{i + 1}", nn.Parameter(
                he_init(generator, shape, c.params_dtype, device)))
            # zero-init the last norm scale of each block (the torchvision
            # / reference recipe for large-batch stability)
            setattr(self, f"bn{i + 1}", BatchNorm(
                shape[-1], c.norm_dtype, device,
                zero_scale=i == len(shapes) - 1))
        self.has_proj = stride != 1 or c_in != c_out
        if self.has_proj:
            self.conv_proj = nn.Parameter(he_init(
                generator, (1, 1, c_in, c_out), c.params_dtype, device))
            self.bn_proj = BatchNorm(c_out, c.norm_dtype, device)

    def _names(self) -> List[Tuple[str, str]]:
        pairs = [(conv, f"bn{i + 1}") for i, conv in enumerate(self.convs)]
        return pairs + ([("conv_proj", "bn_proj")] if self.has_proj else [])

    def params(self) -> Dict[str, Any]:
        out = {}
        for conv, bn in self._names():
            out[conv] = getattr(self, conv)
            out[bn] = getattr(self, bn).params()
        return out

    def stats(self) -> Dict[str, Any]:
        return {bn: getattr(self, bn).stats() for _, bn in self._names()}


class Linear(nn.Module):
    """The classifier: ``weight (fan_in, classes)``, ``bias (classes,)``."""

    def __init__(self, fan_in: int, classes: int, dtype, device, generator):
        super().__init__()
        w = torch.empty((fan_in, classes), dtype=dtype, device=device)
        with torch.no_grad():
            w.normal_(0.0, 1.0, generator=generator).div_(math.sqrt(fan_in))
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(classes, dtype=dtype,
                                             device=device))


class ResNet(nn.Module):
    """ResNet over ``x (N, H, W, 3)`` NHWC images.

    ``device`` defaults to the GPU (and raises without one); pass
    ``device="cpu"`` for the CPU.  Parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` (load JAX weights with
    :func:`apex_tpu_torch.convert.resnet_from_jax` and
    ``load_state_dict``)."""

    def __init__(self, config: ResNetConfig, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        expansion = 4 if c.bottleneck else 1
        self.conv_stem = nn.Parameter(he_init(
            gen, (7, 7, 3, c.width), c.params_dtype, self.device))
        self.bn_stem = BatchNorm(c.width, c.norm_dtype, self.device)
        c_in = c.width
        stages = []
        for s, blocks in enumerate(c.stage_blocks):
            c_mid = c.width * 2 ** s
            c_out = c_mid * expansion
            stage = []
            for b in range(blocks):
                stage.append(Block(c, c_in, c_mid, c_out, self.stride(s, b),
                                   self.device, gen))
                c_in = c_out
            stages.append(nn.ModuleList(stage))
        self.stages = nn.ModuleList(stages)
        self.fc = Linear(c_in, c.num_classes, c.params_dtype, self.device,
                         gen)

    @staticmethod
    def stride(stage: int, block: int) -> int:
        return 2 if stage > 0 and block == 0 else 1

    # --------------------------------------------------------------- trees
    def params_tree(self) -> Dict[str, Any]:
        """The module's parameters as the JAX ``params`` tree (the same
        tensors)."""
        return {"conv_stem": self.conv_stem, "bn_stem": self.bn_stem.params(),
                "stages": [[blk.params() for blk in stage]
                           for stage in self.stages],
                "fc": {"weight": self.fc.weight, "bias": self.fc.bias}}

    def stats_tree(self) -> Dict[str, Any]:
        """The module's running statistics as the JAX ``batch_stats``
        tree (the same tensors)."""
        return {"bn_stem": self.bn_stem.stats(),
                "stages": [[blk.stats() for blk in stage]
                           for stage in self.stages]}

    @torch.no_grad()
    def load_stats(self, new: Dict[str, Any]) -> None:
        """Copy a ``batch_stats`` tree into the buffers."""
        def copy(dst, src):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
            elif isinstance(dst, dict):
                for k in dst:
                    copy(dst[k], src[k])
            else:
                for d, s in zip(dst, src):
                    copy(d, s)

        copy(self.stats_tree(), new)

    # ------------------------------------------------------------- forward
    def _bn(self, p, st, x, training: bool):
        c = self.config
        out, mean, var = sync_batch_norm(
            x, p["scale"], p["bias"], st["mean"], st["var"],
            training=training, momentum=c.bn_momentum, eps=c.bn_eps,
            axis_name=c.sync_bn_axis if training else None)
        return out, {"mean": mean, "var": var}

    def _block(self, p, st, x, stride: int, training: bool):
        new = {}
        relu = torch.relu
        if self.config.bottleneck:
            h, new["bn1"] = self._bn(p["bn1"], st["bn1"],
                                     conv_nhwc(x, p["conv1"]), training)
            h, new["bn2"] = self._bn(p["bn2"], st["bn2"],
                                     conv_nhwc(relu(h), p["conv2"], stride),
                                     training)
            h, new["bn3"] = self._bn(p["bn3"], st["bn3"],
                                     conv_nhwc(relu(h), p["conv3"]), training)
        else:
            h, new["bn1"] = self._bn(p["bn1"], st["bn1"],
                                     conv_nhwc(x, p["conv1"], stride),
                                     training)
            h, new["bn2"] = self._bn(p["bn2"], st["bn2"],
                                     conv_nhwc(relu(h), p["conv2"]), training)
        identity = x
        if "conv_proj" in p:
            identity, new["bn_proj"] = self._bn(
                p["bn_proj"], st["bn_proj"],
                conv_nhwc(x, p["conv_proj"], stride), training)
        return relu(h + identity), new

    def apply(self, params: Optional[Dict[str, Any]] = None,
              batch_stats: Optional[Dict[str, Any]] = None,
              x: Optional[torch.Tensor] = None,
              training: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``x (N, H, W, 3)`` -> ``(logits (N, classes) fp32,
        new_batch_stats)``, as JAX's ``apply``; ``params`` and
        ``batch_stats`` default to the module's own trees, and the
        buffers are not written (``forward`` writes them)."""
        c = self.config
        params = self.params_tree() if params is None else params
        batch_stats = self.stats_tree() if batch_stats is None \
            else batch_stats
        h = conv_nhwc(x.to(c.compute_dtype), params["conv_stem"], stride=2)
        new = {}
        h, new["bn_stem"] = self._bn(params["bn_stem"],
                                     batch_stats["bn_stem"], h, training)
        h = max_pool_nhwc(torch.relu(h), 3, 2)
        new["stages"] = []
        for s, stage in enumerate(params["stages"]):
            blk_stats = []
            for b, blk in enumerate(stage):
                h, st = self._block(blk, batch_stats["stages"][s][b], h,
                                    self.stride(s, b), training)
                blk_stats.append(st)
            new["stages"].append(blk_stats)
        h = h.float().mean(dim=(1, 2))
        fc = params["fc"]
        return h @ fc["weight"].float() + fc["bias"].float(), new

    def forward(self, x: torch.Tensor,
                training: Optional[bool] = None) -> torch.Tensor:
        """Logits of ``x`` on the module's parameters; ``training``
        (default: ``self.training``) normalizes by the batch and writes
        the new running statistics into the buffers."""
        training = self.training if training is None else training
        logits, new = self.apply(None, None, x, training)
        if training:
            self.load_stats(new)
        return logits

    # ------------------------------------------------------------ counting
    def flops_per_image(self, image_size: int) -> int:
        """Forward FLOPs of one image's convolutions and ``fc`` (2 per
        multiply-add), from the shapes: what an MFU counts."""
        c = self.config
        total, size = 0, image_size

        def conv(n, k, cin, cout, stride):
            out = -(-n // stride)
            return 2 * out * out * k * k * cin * cout, out

        f, size = conv(size, 7, 3, c.width, 2)
        total += f
        size = -(-size // 2)                # the max pool
        for s, stage in enumerate(self.stages):
            for b, blk in enumerate(stage):
                stride = self.stride(s, b)
                n = size
                for i, name in enumerate(blk.convs):
                    w = getattr(blk, name)
                    st = stride if (i == (1 if c.bottleneck else 0)) else 1
                    f, n = conv(n, w.shape[0], w.shape[2], w.shape[3], st)
                    total += f
                if blk.has_proj:
                    w = blk.conv_proj
                    total += conv(size, 1, w.shape[2], w.shape[3], stride)[0]
                size = n
        return total + 2 * self.fc.weight.shape[0] * self.fc.weight.shape[1]


def resnet50(*, device=None, seed: int = 0, **kw) -> ResNet:
    return ResNet(ResNetConfig(depth=50, **kw), device=device, seed=seed)
