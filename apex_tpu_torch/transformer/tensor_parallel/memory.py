"""Host staging buffers: ``GlobalMemoryBuffer`` and ``RingMemBuffer``.

The port's own copy of ``apex_tpu/transformer/tensor_parallel/memory.py``:
reusable numpy buffers for the input pipeline, keyed by name, shape and
dtype, and a ring of N buffers so that buffer k + 1 fills while buffer k
is still being copied to the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["GlobalMemoryBuffer", "RingMemBuffer"]


class GlobalMemoryBuffer:
    """Reusable host buffers keyed by ``(name, shape, dtype)``."""

    def __init__(self):
        self.buffer: Dict[Tuple, np.ndarray] = {}

    def get_tensor(self, shape, dtype, name: str) -> np.ndarray:
        key = (name, tuple(shape), np.dtype(dtype).name)
        buf = self.buffer.get(key)
        if buf is None:
            buf = np.empty(shape, dtype)
            self.buffer[key] = buf
        return buf


class RingMemBuffer:
    """``num_buffers`` host buffers handed out in turn."""

    def __init__(self, name: str, num_buffers: int, shape, dtype):
        self.buffers = [np.empty(shape, dtype) for _ in range(num_buffers)]
        self._idx = -1

    def get_next_buffer(self) -> np.ndarray:
        self._idx = (self._idx + 1) % len(self.buffers)
        return self.buffers[self._idx]
