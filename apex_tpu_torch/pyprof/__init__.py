"""Profiling: named ranges, traces, per-op and per-class tables, and a
cost count of a function's FLOPs and bytes.

Counterpart of ``apex_tpu/pyprof/__init__.py`` (reference: apex/pyprof,
three stages: NVTX markers, nvprof parsing, per-kernel FLOP/byte
classes).  On the H100:

1. **markers**: :func:`annotate` / :func:`trace_region` open a
   ``torch.profiler.record_function`` range, and an NVTX range on a CUDA
   host (a CPU-only build of PyTorch has no NVTX, so the range is skipped
   there by a device check);
2. **parse**: :func:`trace` captures a ``torch.profiler`` Chrome trace
   (host and device activities) into a directory that :func:`parse` reads
   back as per-op rows;
3. **prof**: :func:`prof` files the rows into JAX's op classes, and
   :func:`cost_analysis` counts a call's FLOPs and bytes: each kernel
   wrapper of the port reports the work of its launch (the formulas of
   PERF.md's bound column, ``ops/common.py``'s cost hook), and every
   other PyTorch operator is counted by ``torch.utils.flop_counter``'s
   formulas (FLOPs) and its inputs plus outputs (bytes).  A wrapper's
   plain version reports its kernel's numbers and its own operators are
   not counted again, so a function counts the same on the CPU and on the
   card.  :func:`utilization` marries the two into achieved FLOP/s and
   bytes/s.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from apex_tpu_torch.ops import common
from apex_tpu_torch.pyprof.parse import op_table, parse  # noqa: F401
from apex_tpu_torch.pyprof.prof import (  # noqa: F401
    OP_CLASSES,
    classify,
    prof,
    prof_table,
    utilization,
)
from apex_tpu_torch.telemetry.spans import TRACE_FILE

__all__ = [
    "annotate",
    "trace_region",
    "trace",
    "parse",
    "op_table",
    "classify",
    "prof",
    "prof_table",
    "utilization",
    "OP_CLASSES",
    "cost_analysis",
    "summarize",
    "Timers",
]


def annotate(fn: Optional[Callable] = None, name: Optional[str] = None):
    """Decorator running a function inside :func:`trace_region` of its
    name (or ``name``): the analog of pyprof.nvtx's wrapping,
    reference: nvmarker.py:67-108, opt-in per function."""

    def deco(f):
        label = name or getattr(f, "__name__", "fn")

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with trace_region(label):
                return f(*args, **kwargs)

        return wrapper

    if fn is None:
        return deco
    return deco(fn)


@contextlib.contextmanager
def trace_region(name: str):
    """A named range: a ``record_function`` range in a profiler trace and,
    where CUDA is present, an NVTX range for an external profiler."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block, host and (on a
    CUDA host) device activities, as a Chrome trace in a new
    ``run<N>/trace.json`` under ``log_dir`` (:func:`parse` reads every
    run there)."""
    os.makedirs(log_dir, exist_ok=True)
    n = sum(1 for d in os.listdir(log_dir) if d.startswith("run"))
    out = os.path.join(log_dir, f"run{n}")
    os.makedirs(out)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    try:
        yield out
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        profiler.stop()
        profiler.export_chrome_trace(os.path.join(out, TRACE_FILE))


# ------------------------------------------------------------------- costs

def _is_free(func) -> bool:
    """An operator that moves no bytes: one outside ATen (a device query
    such as ``prim.device``, a profiler range), a view, or an allocation
    that writes nothing."""
    if func.namespace != "aten":
        return True
    name = func._overloadpacket.__name__
    return bool(getattr(func, "is_view", False)) or name in (
        "empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "detach", "alias", "lift_fresh",
        "_unsafe_view", "view", "_reshape_alias", "as_strided")


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class _OperatorCost(TorchDispatchMode):
    """FLOPs (``torch.utils.flop_counter``'s formulas) and bytes (inputs
    plus outputs) of the PyTorch operators run outside a kernel wrapper's
    device branch."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if common.in_kernel_entry() or _is_free(func):
            return out
        packet = func._overloadpacket
        flops = (float(self.registry[packet](*args, **kwargs, out_val=out))
                 if packet in self.registry else 0.0)
        nbytes = float(_tensor_bytes((args, kwargs)) + _tensor_bytes(out))
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(str(func), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """The FLOPs and bytes of one call ``fn(*args, **kwargs)``, counted
    while it runs (the call's effects happen): ``{"flops", "bytes
    accessed", "kernels", "operators", "operator flops", "operator bytes
    accessed"}``, ``kernels`` by launch counter and ``operators`` by
    PyTorch operator, each ``{name: {"calls", "flops", "bytes
    accessed"}}``.  Run it on fake tensors
    (``torch._subclasses.fake_tensor.FakeTensorMode``) to count a
    configuration too large to run on the CPU; a kernel whose count
    depends on data (segment ids, decode lengths) needs real tensors.  A
    CUDA graph's replay runs no operator and no wrapper, so count the
    eager step it replays."""
    with common.CostRecorder() as rec, _OperatorCost() as ops:
        fn(*args, **kwargs)
    def table(rows):
        return {name: {"calls": int(c), "flops": f, "bytes accessed": b}
                for name, (c, f, b) in sorted(rows.items())}

    return {
        "flops": rec.flops + ops.flops,
        "bytes accessed": rec.bytes + ops.bytes,
        "kernels": table(rec.kernels),
        "operators": table(ops.by_op),
        "operator flops": ops.flops,
        "operator bytes accessed": ops.bytes,
    }


def summarize(fn: Callable, *args, peak_flops: Optional[float] = None,
              peak_bandwidth: Optional[float] = None, **kwargs) -> dict:
    """FLOPs / bytes / arithmetic-intensity report of one call (the
    reference's ``prof`` output).  With ``peak_*`` given, adds the
    roofline's bound: which rate bounds it and the least time."""
    from apex_tpu_torch.pyprof.prof import _cost_numbers

    costs = cost_analysis(fn, *args, **kwargs)
    flops, bytes_accessed = _cost_numbers(costs)
    out = {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": flops / bytes_accessed
        if bytes_accessed else float("inf"),
    }
    if peak_flops and peak_bandwidth and bytes_accessed:
        t_compute = flops / peak_flops
        t_memory = bytes_accessed / peak_bandwidth
        out["compute_bound"] = t_compute >= t_memory
        out["min_time_s"] = max(t_compute, t_memory)
    return out


def _barrier(tree: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``."""
    leaves, _ = tree_flatten(tree)
    for dev in {t.device for t in leaves
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timers:
    """Named wall timers with device sync
    (reference: apex/transformer/pipeline_parallel/_timers.py:5-83;
    ``barrier_on`` waits for the CUDA devices of its tensors)."""

    class _Timer:
        def __init__(self, name):
            self.name = name
            self.elapsed_ = 0.0
            self.started = False
            self._start = 0.0

        def start(self, barrier_on: Any = None):
            if self.started:
                # JAX's Timers assert; raised outright, so -O keeps it
                raise AssertionError(f"timer {self.name} already started")
            if barrier_on is not None:
                _barrier(barrier_on)
            self._start = time.perf_counter()
            self.started = True

        def stop(self, barrier_on: Any = None):
            if not self.started:
                raise AssertionError(f"timer {self.name} not started")
            if barrier_on is not None:
                _barrier(barrier_on)
            self.elapsed_ += time.perf_counter() - self._start
            self.started = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started = False

        def elapsed(self, reset: bool = True) -> float:
            e = self.elapsed_
            if reset:
                self.reset()
            return e

    def __init__(self):
        self.timers: Dict[str, Timers._Timer] = {}

    def __call__(self, name: str) -> "Timers._Timer":
        if name not in self.timers:
            self.timers[name] = self._Timer(name)
        return self.timers[name]

    def log(self, names=None, normalizer: float = 1.0) -> str:
        names = names or list(self.timers)
        parts = [
            f"{n}: {self.timers[n].elapsed(reset=False) * 1000.0 / normalizer:.2f}"
            for n in names if n in self.timers
        ]
        return "time (ms) | " + " | ".join(parts)
