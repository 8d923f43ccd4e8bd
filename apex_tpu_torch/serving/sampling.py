"""On-device token sampling, greedy so far.

Counterpart of ``apex_tpu/serving/sampling.py``.  The sampled ids stay on
the device and feed the next decode step directly; they reach the host
only at the serving driver's harvest.  ``temperature=0`` is greedy:
argmax with the FIRST maximum on ties, as ``jnp.argmax`` does.
Temperature sampling with top-k / top-p (and the JAX PRNG reproduced
for seeded streams) is ROADMAP.md queue A item 3; speculative acceptance
is item 7.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["greedy", "sample"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis, int32, first maximum on ties."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(
    logits: torch.Tensor,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """One token id per row of ``logits (..., vocab)``, int32, on the
    logits' device.  Only ``temperature == 0`` (greedy, which ignores
    ``top_k``/``top_p``) is ported."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature == 0.0:
        return greedy(logits)
    raise NotImplementedError(
        "temperature > 0 sampling is not ported yet "
        "(ROADMAP.md queue A item 3)")
