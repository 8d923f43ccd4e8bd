"""Throughput arithmetic: model FLOPs per token and the device's peak.

The port's own copy of the two functions of ``apex_tpu/telemetry/
metrics.py`` that tokens/s and MFU are computed from, so that the port's
MFU has the same numerator as the JAX package's (``6·N + 12·L·h·s``).
The peak table holds the NVIDIA cards the port runs on (data sheet, dense
bf16 tensor-core rate, SXM parts at their full power limit).  The rest of
that module (the async ``MetricsLogger``, ``StepStats``) is ROADMAP.md
queue A item 10.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["transformer_flops_per_token", "device_peak_flops", "mfu"]

#: dense bf16 tensor-core peaks by device-name substring
PEAK_BF16_FLOPS = (
    ("H100", 989e12),
    ("H200", 989e12),
)


def transformer_flops_per_token(n_params: int, num_layers: int,
                                hidden_size: int, seq_len: int) -> int:
    """Model FLOPs per trained token: ``6·N`` (forward and backward
    matmuls) plus ``12·L·h·s`` (attention scores and context).  ``N`` is
    the model's parameter count as it stands: a SwiGLU model's gate
    (``fc_gate``, the third FFN matrix) is in it, and so is a learned
    position table, which a rope model does not have."""
    return 6 * n_params + 12 * num_layers * hidden_size * seq_len


def device_peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a CUDA device by name; None for the CPU
    or a card with no table entry (MFU is then omitted, not made up)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for key, peak in PEAK_BF16_FLOPS:
        if key in name:
            return peak
    return None


def mfu(tokens_per_s: float, flops_per_token: float,
        peak: Optional[float]) -> Optional[float]:
    """Model FLOPs utilisation, or None without a peak."""
    return None if not peak else tokens_per_s * flops_per_token / peak
