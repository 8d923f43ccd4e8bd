"""Device resolution: the GPU is the default device of every entry point.

The JAX package probes its backend to choose between a Pallas kernel and
an XLA fallback (``apex_tpu/utils/platform.py``).  The port has no such
choice: on a CUDA tensor a kernel launches or raises, and the plain
PyTorch versions run only on CPU tensors.  So the one decision left is
where an entry point puts its tensors, and that is never made silently:
with no argument it is the current CUDA device, and without a GPU it
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device and raises ``RuntimeError``
    when there is none.  ``"cpu"`` selects the plain PyTorch versions of
    the kernels (the tests run there).  ``"cuda"``/``"cuda:N"`` name a
    GPU explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: apex_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
