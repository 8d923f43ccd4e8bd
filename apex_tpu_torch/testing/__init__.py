"""Test utilities: the counterpart of ``apex_tpu/testing/__init__.py``.

JAX's skip decorators ask its backend for a TPU; the port's ask PyTorch
for a Hopper GPU.  ``TEST_WITH_GPU`` is read from
``APEX_TPU_TORCH_TEST_WITH_GPU`` ("1" turns it on), as JAX's
``TEST_WITH_TPU`` from ``APEX_TPU_TEST_WITH_TPU``.
"""

from __future__ import annotations

import functools
import os
import unittest

import torch

__all__ = ["TEST_WITH_GPU", "skipIfNoGpu", "skipIfCpu"]

TEST_WITH_GPU = os.environ.get("APEX_TPU_TORCH_TEST_WITH_GPU", "0") == "1"

#: the compute capability the port's kernels are built for (``sm_90a``)
HOPPER = (9, 0)


def _hopper() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == HOPPER)


def skipIfNoGpu(fn):
    """Skip unless CUDA reports a Hopper GPU (sm_90), the card the
    kernels are built for."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _hopper():
            raise unittest.SkipTest("test requires an sm_90 GPU")
        return fn(*args, **kwargs)

    return wrapper


def skipIfCpu(fn):
    """Skip when PyTorch sees no CUDA device."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not torch.cuda.is_available():
            raise unittest.SkipTest("test skipped on CPU")
        return fn(*args, **kwargs)

    return wrapper
