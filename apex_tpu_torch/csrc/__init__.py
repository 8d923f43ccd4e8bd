"""Native host helpers, the ``apex_C`` extension analog.

The port's counterpart of ``apex_tpu/csrc/__init__.py``.  Its own copy
of :file:`apex_c.cpp` (a host library, not one of the CUDA sources of
``ops/common.py``'s ``KERNEL_SOURCES``) is compiled at first use by the
host C++ compiler (``$CXX``, else ``g++``, else ``c++``) into
``apex_tpu_torch/_build/`` and called through ctypes over the contiguous
host byte views of torch tensors: a bf16 tensor is moved as its 2-byte
words, never through a numpy dtype.

There is no silent fallback: a missing compiler or a failed build raises
:class:`NativeUnavailable`.  The numpy versions beside the entry points
(:func:`flatten_plain`, :func:`unflatten_plain`,
:func:`plan_buckets_plain`) are the plain versions the tests hold the
library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["flatten", "unflatten", "plan_buckets", "flatten_plain",
           "unflatten_plain", "plan_buckets_plain", "byte_view",
           "NativeUnavailable"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "apex_c.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    """The host library could not be built or loaded."""


def _compiler() -> str:
    for c in (os.environ.get("CXX"), shutil.which("g++"),
              shutil.which("c++")):
        if c and shutil.which(c):
            return shutil.which(c)
    raise NativeUnavailable(
        "no host C++ compiler ($CXX, g++ or c++ on PATH): apex_c.cpp is "
        "built at first use")


def _lib_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"apex_c-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = _lib_path()
        if not so.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise NativeUnavailable(
                    f"building {SOURCE.name} failed (exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.apex_c_flatten.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32]
        lib.apex_c_flatten.restype = None
        lib.apex_c_unflatten.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32]
        lib.apex_c_unflatten.restype = None
        lib.apex_c_plan_buckets.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.apex_c_plan_buckets.restype = ctypes.c_int64
        _LIB = lib
        return lib


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """The contiguous 1-D uint8 view of a host tensor's bytes (a copy
    only where ``t`` is not contiguous); 0-d tensors included."""
    if t.device.type != "cpu":
        raise ValueError(f"byte_view needs a host tensor, got {t.device}")
    t = t.detach().contiguous().reshape(-1)
    return t.view(torch.uint8) if t.dtype != torch.uint8 else t


def flatten(tensors: Sequence[torch.Tensor], threads: int = 8,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate host tensors byte-wise into one uint8 tensor (``out``
    when given: a contiguous uint8 host tensor of exactly their bytes,
    pinned memory included)."""
    views = [byte_view(t) for t in tensors]
    nbytes = [v.numel() for v in views]
    total = sum(nbytes)
    if out is None:
        out = torch.empty((total,), dtype=torch.uint8)
    elif (out.dtype != torch.uint8 or out.numel() != total
          or not out.is_contiguous() or out.device.type != "cpu"):
        raise ValueError(f"out must be a contiguous host uint8 tensor of "
                         f"{total} bytes")
    if not views:
        return out
    lib = _load()
    n = len(views)
    srcs = (ctypes.c_void_p * n)(*[v.data_ptr() for v in views])
    sizes = (ctypes.c_int64 * n)(*nbytes)
    lib.apex_c_flatten(srcs, sizes, n, ctypes.c_void_p(out.data_ptr()),
                       threads)
    return out


def unflatten(flat: torch.Tensor, shapes: Sequence[Tuple[int, ...]],
              dtypes: Sequence[torch.dtype],
              threads: int = 8) -> List[torch.Tensor]:
    """Split a flat host uint8 tensor back into tensors of the given
    shapes and dtypes."""
    flat = byte_view(flat)
    outs = [torch.empty(tuple(s), dtype=d) for s, d in zip(shapes, dtypes)]
    nbytes = [o.numel() * o.element_size() for o in outs]
    if sum(nbytes) != flat.numel():
        raise ValueError(
            f"flat buffer has {flat.numel()} bytes but shapes/dtypes "
            f"describe {sum(nbytes)}")
    if not outs:
        return outs
    lib = _load()
    n = len(outs)
    dsts = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    sizes = (ctypes.c_int64 * n)(*nbytes)
    lib.apex_c_unflatten(ctypes.c_void_p(flat.data_ptr()), dsts, sizes, n,
                         threads)
    return outs


def plan_buckets(nbytes: Sequence[int], cap_bytes: int) -> torch.Tensor:
    """Greedy size-capped bucket ids (int32), in order: a new bucket
    starts where adding a tensor would pass ``cap_bytes`` (a lone
    oversized tensor still gets its own)."""
    n = len(nbytes)
    ids = torch.empty((n,), dtype=torch.int32)
    if not n:
        return ids
    lib = _load()
    arr = (ctypes.c_int64 * n)(*[int(b) for b in nbytes])
    lib.apex_c_plan_buckets(
        arr, n, int(cap_bytes),
        ctypes.cast(ctypes.c_void_p(ids.data_ptr()),
                    ctypes.POINTER(ctypes.c_int32)))
    return ids


# ------------------------------------------------------- plain versions
def flatten_plain(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    """:func:`flatten` in numpy over the byte views."""
    views = [byte_view(t).numpy() for t in tensors]
    return (np.concatenate(views) if views
            else np.zeros((0,), np.uint8))


def unflatten_plain(flat: np.ndarray, shapes: Sequence[Tuple[int, ...]],
                    dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
    """:func:`unflatten` in numpy over the byte views."""
    flat = np.ascontiguousarray(flat).view(np.uint8).reshape(-1)
    outs, off = [], 0
    for s, d in zip(shapes, dtypes):
        t = torch.empty(tuple(s), dtype=d)
        nb = t.numel() * t.element_size()
        byte_view(t).numpy()[:] = flat[off:off + nb]
        outs.append(t)
        off += nb
    if off != flat.size:
        raise ValueError(f"flat buffer has {flat.size} bytes but "
                         f"shapes/dtypes describe {off}")
    return outs


def plan_buckets_plain(nbytes: Sequence[int], cap_bytes: int) -> np.ndarray:
    """:func:`plan_buckets` in numpy."""
    ids = np.empty(len(nbytes), np.int32)
    bucket = used = 0
    for i, nb in enumerate(nbytes):
        if used > 0 and used + nb > cap_bytes:
            bucket += 1
            used = 0
        ids[i] = bucket
        used += nb
    return ids
