"""Building, loading and counting the port's CUDA kernels.

The JAX package's ``ops/common.py`` dispatches between a Pallas kernel and
an XLA fallback (``run_kernel``).  The port has no such seam: a kernel
wrapper given a CUDA tensor launches its kernel or raises
(:class:`KernelUnavailable` when the kernel cannot be built or loaded, a
``ValueError`` for a shape it does not take), and the plain PyTorch
version runs only for CPU tensors.

Build route: each ``csrc/<name>.cu`` is compiled on first use by ``nvcc``
into a shared library with a plain C interface and loaded with
``ctypes`` (pointers and the stream passed as ``c_void_p``).  Every C
entry returns ``cudaGetLastError()`` after its launch, and
:func:`check` turns a non-zero code into an exception.  The libraries
land in ``apex_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name that carries the hash of the source and flags, so a stale build is
never loaded.  :func:`build` starts one ``nvcc`` per source, all at once.

Launch counters: every wrapper calls :func:`count_launch` where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (``chip_smoke.py`` resets them with
:func:`reset_launch_counts` right before the main path).  The launch
runs inside the context :func:`count_launch` returns: while a profiler
runs, a ``record_function`` range named by the counter, so the trace
carries the counter's name beside the kernels it launched; otherwise
nothing.

Cost hook: each wrapper's entry (the function that branches between
the kernel on a CUDA tensor and the plain version on a CPU one) is
declared with :func:`kernel_entry` and the work of its kernel calls, the
FLOPs (operations) and bytes of PERF.md's bound column (each operand
read once, each output written once).  While a :class:`CostRecorder`
is active (``apex_tpu_torch.pyprof.cost_analysis``), the entry reports
that work on either branch, and :func:`in_kernel_entry` is true while
it runs, so a recorder that also counts PyTorch's own operators (a
``TorchDispatchMode``) does not count the wrapper's allocations or its
plain version's operators a second time: the count of a function is the
same on the CPU and on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

__all__ = [
    "KernelUnavailable", "build", "load", "check", "count_launch",
    "launch_counts", "reset_launch_counts", "stream_of", "check_operands",
    "check_implementation", "KERNEL_SOURCES", "as_int32", "split_scratch",
    "split_scratch_tensors", "add_launch_counts", "f16_name",
    "CostRecorder", "kernel_entry", "in_kernel_entry",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: the CUDA sources this package builds (``csrc/<name>.cu``)
KERNEL_SOURCES = ("attention_short", "attention_mid", "attention_flash",
                  "attention_short_f16", "attention_mid_f16",
                  "attention_flash_f16", "attention_short_f32",
                  "attention_mid_f32", "attention_flash_f32",
                  "attention_decode", "attention_decode_f16",
                  "dequant_matmul", "dequant_matmul_f16", "layer_norm",
                  "multi_tensor")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)


class KernelUnavailable(RuntimeError):
    """A kernel could not be built, loaded or launched.  Never caught
    inside the package: a CUDA tensor has no other path."""


# ---------------------------------------------------------------- counters

_LAUNCHES: Dict[str, int] = {}


def f16_name(name: str, dtype: torch.dtype) -> str:
    """``name`` with ``_f16`` last for an fp16 ``dtype``: the launch
    counter of a kernel's fp16 instance, and the CUDA source that holds
    the paged decode's and the dequant pair's fp16 instances
    (``csrc/<name>_f16.cu``, the same code built by its own ``nvcc``)."""
    return name + "_f16" if dtype == torch.float16 else name


def count_launch(name: str):
    """Add one launch of kernel ``name``, called by its wrapper right where
    it launches the kernel.  Returns the context the wrapper launches in
    (``with count_launch(name): err = fn(...)``): a ``record_function``
    range named ``name`` while a profiler runs, so its trace names the
    kernels of the launch, and otherwise a no-op."""
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


_NO_RANGE = contextlib.nullcontext()


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counts since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in list(_LAUNCHES):
        _LAUNCHES[name] = 0


def add_launch_counts(counts: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` to the launch counts: a CUDA graph's
    replay launches what its capture counted, without calling the
    wrappers, and its capture launched nothing
    (``serving/graphs.py``)."""
    for name, n in counts.items():
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + sign * int(n)


# ------------------------------------------------------------------- costs

class CostRecorder:
    """The work of the kernels launched (or run as plain versions) while
    it is active: ``flops`` and ``bytes`` in all, and by kernel name
    ``{name: [calls, flops, bytes]}``.  Entered as a context manager;
    recorders nest, and each active one sees every report."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, List[float]] = {}

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.kernels.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def __enter__(self) -> "CostRecorder":
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _RECORDERS.remove(self)


_RECORDERS: List[CostRecorder] = []
#: depth of :func:`kernel_entry` calls on the stack
_ENTRY_DEPTH = [0]


def in_kernel_entry() -> bool:
    """True inside a wrapper's entry (:func:`kernel_entry`) while a
    recorder is active: PyTorch operators run here belong to a kernel's
    reported cost."""
    return _ENTRY_DEPTH[0] > 0


def kernel_entry(costs: Callable[..., Iterable[Tuple[str, Tuple]]]):
    """Declare a wrapper's entry, the function that launches its kernels
    on a CUDA tensor or runs their plain version on a CPU one, and the
    work of those kernel calls: ``costs`` takes the entry's arguments and
    yields ``(counter, (operations, bytes))`` for each launch the call
    makes (none where it launches nothing).  While a recorder is active,
    the entry reports them after the call returns, on either branch;
    otherwise the entry is the function itself, called straight through.
    """

    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if not _RECORDERS:
                return fn(*args, **kwargs)
            _ENTRY_DEPTH[0] += 1
            try:
                out = fn(*args, **kwargs)
                # counted from this call's operands (segment ids and
                # decode lengths are data)
                for name, (flops, nbytes) in costs(*args, **kwargs):
                    for rec in _RECORDERS:
                        rec.add(name, float(flops), float(nbytes))
            finally:
                _ENTRY_DEPTH[0] -= 1
            return out

        return entry

    return wrap


# ------------------------------------------------------------------ build

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: seconds from the start of the last :func:`build` to each of its
#: compiles' end (the build's wall is the largest)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if home:
        candidates.append(str(Path(home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise KernelUnavailable(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda): "
        "the port's CUDA kernels are built from csrc/ at first use")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    h = hashlib.sha1(text)
    # an _f16 or _f32 source includes its twin's .cu
    for inc in re.findall(rb'#include "([\w.]+\.cu)"', text):
        h.update((CSRC / inc.decode()).read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that have no current
    build, one ``nvcc`` process per source, all started together.
    Returns ``name -> nvcc output`` (the ``-Xptxas -v`` register and
    shared-memory report) for the sources compiled by this call; raises
    :class:`KernelUnavailable` if any compile fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if not _lib_path(n).is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    t0 = time.perf_counter()
    BUILD_SECONDS.clear()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    # read each compiler's report as it comes (a full pipe would stall it),
    # noting when each one ends
    readers = {n: threading.Thread(target=lambda p=p, n=n: _drain(p, n))
               for n, _, _, p in procs}
    for t in readers.values():
        t.start()
    for t in readers.values():
        t.join()
    logs, failed = {}, []
    for n, out, tmp, p in procs:
        text = _OUTPUT.pop(n)
        BUILD_SECONDS[n] = _ENDED.pop(n) - t0
        logs[n] = text
        if p.returncode != 0:
            failed.append(f"{n} (nvcc exit {p.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelUnavailable("kernel build failed: " + "\n".join(failed))
    return logs


_OUTPUT: Dict[str, str] = {}
_ENDED: Dict[str, float] = {}


def _drain(proc, name: str) -> None:
    _OUTPUT[name] = proc.communicate()[0]
    _ENDED[name] = time.perf_counter()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(str(_lib_path(name)))
            except OSError as e:
                raise KernelUnavailable(f"cannot load {name}: {e}") from e
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, kernel: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.error_string(err).decode(errors="replace")
        raise KernelUnavailable(f"{kernel}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as the C entries take
    it: kernels launch there and never synchronise."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def as_int32(word: int) -> int:
    """A uint32 value as the int32 with its bits: how a C entry's
    ``unsigned`` argument (typed ``c_int``) and a Triton kernel's key words
    take it."""
    word = int(word) & 0xFFFFFFFF
    return word - (1 << 32) if word >= (1 << 31) else word


#: the split kernels' scratch, per (device, stream): fp32 partials and the
#: merge tickets' int32 counters, one zeroed buffer the kernels leave at 0,
#: so a call needs no memset.  Calls on one stream run in order and never
#: share them.  A buffer outgrown is kept, not freed: a captured CUDA graph
#: may still launch on it.
_SCRATCH: Dict = {}
_RETIRED: List = []


def split_scratch_tensors(device: torch.device, stream, floats: int,
                          counters: int):
    """``(values, indices, counters)``: the first ``floats / 2`` fp32 of
    the (device, stream) workspace, the next ``floats / 2`` as int32, and
    the zeroed int32 counters: a split reduction's (value, index)
    partials and its merge tickets (the Gumbel-max sampler's)."""
    _scratch(device, stream, floats, counters)
    ws, cnt = _SCRATCH[(device.index, stream)]
    half = floats // 2
    return ws[:half], ws[half:2 * half].view(torch.int32), cnt


def split_scratch(device: torch.device, stream, floats: int,
                  counters: int):
    """Pointers to ``floats`` fp32 of workspace and ``counters`` zeroed
    int32 counters on ``device`` for kernels on ``stream`` (the paged
    decode's and the dequant matmul's k split)."""
    ws, cnt = _scratch(device, stream, floats, counters)
    return ws.data_ptr(), cnt.data_ptr()


def _scratch(device: torch.device, stream, floats: int, counters: int):
    key = (device.index, stream)
    ws, cnt = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        _RETIRED.append(ws)
        ws = torch.empty(max(floats, 2 * (0 if ws is None else ws.numel())),
                         dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < counters:
        _RETIRED.append(cnt)
        cnt = torch.zeros(max(counters, 4096,
                              2 * (0 if cnt is None else cnt.numel())),
                          dtype=torch.int32, device=device)
    _SCRATCH[key] = (ws, cnt)
    return ws, cnt


def check_operands(kernel: str, *tensors: torch.Tensor) -> None:
    """Reject a launch whose operands are not all contiguous tensors on
    one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operand of shape {tuple(t.shape)} "
                             "is not contiguous")


def check_implementation(kernel: str, implementation: Optional[str],
                         names: Iterable[str] = ("pallas",)) -> None:
    """The JAX ``implementation=`` argument of an ops entry point: None or
    one of ``names`` (the JAX names of the kernel) runs the kernel, which
    on a CPU tensor is its plain version.  Anything else raises: the JAX
    ``"xla"`` path has no counterpart here, since a plain version is the
    CPU path and the kernel's oracle, never a path on the card."""
    names = tuple(names)
    if implementation is not None and implementation not in names:
        raise ValueError(
            f"{kernel}: implementation={implementation!r}: the port runs "
            f"its kernel (None or one of {names}); its plain version is the "
            "CPU path and the oracle, not a path on the GPU")
