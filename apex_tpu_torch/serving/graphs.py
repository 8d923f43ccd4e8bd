"""One CUDA graph per step shape: the serving steps replayed.

The JAX package compiles each serving step once per shape (``jax.jit``,
``apex_tpu/models/gpt.py`` ``decode_fns``) and dispatches a step as one
call.  Eager PyTorch dispatches every operation of a step from Python:
a flagship decode step is some 300 launches, each costing the host more
than the device takes to run it.  :class:`StepGraph` is the port's
counterpart of that contract for the steps that run once a token (the
decode step and the verify step): on the card,

1. the first call at a signature (the shapes and dtypes of its tensors,
   and the pools it updates) runs the step eagerly on a side stream,
   which warms every workspace at the server's shape (Triton's compile,
   the cached rope tables, the split kernels' scratch of that stream) and
   returns the eager result;
2. it then captures the step once into a CUDA graph over static input
   buffers (capture launches nothing);
3. every later call copies its tensors into the static inputs (skipping
   a tensor that already is one) and replays the graph.

The step's signature is ``step(pools, carry, *tensors) -> (pools, carry,
*outputs)``: the pools are updated in place, so the graph writes the live
pools; the new carry is copied back into the static carry inside the
graph, so a replayed call returns the static carry, which the caller
hands back on its next call without a copy.  Every output of a replay is
a static buffer that the next replay overwrites: a caller that keeps one
past the next call copies it (the batcher's harvest window does).

A replay does not call the kernel wrappers, so it would not count their
launches (``ops/common.py``): the counts a capture adds are taken back
and added again on every replay.  A failed capture or replay raises; it
never falls back to the eager step.

**One graph per (pools, step shape).**  A fleet drives N batchers, each
over its own pools, through ONE set of step functions (JAX's "N
replicas share one set of jitted step functions": zero extra
compilations).  The graphs are keyed by the pools' identity (each
buffer's address and shape) as well as the signature, so every replica
keeps its own captures, and with them its own static carry: the carry a
replay returns is that replica's, and the in-place writes the batcher
makes between steps (admission, retirement, cancel, a handoff's import)
land in it and nowhere else.  Captures are bounded by live replicas x
step shapes, and once each replica has run each shape a fleet makes no
new capture: the port's form of "zero extra compilations".  Graphs over
pools that are gone are dropped with them (a weak reference on the
pools' ``k`` buffer), so short-lived batchers do not pile up captures.

What each replica's graphs hold on the card, per step shape: the static
inputs (that replica's carry, ``max_seqs`` x 33 bytes, and its page
table, ``max_seqs`` x ``pages_per_seq`` x 4 bytes) and the private memory
pool the capture reserved for the step's intermediates (the activations
of ``max_seqs`` rows through every layer, the fp32 logits of ``max_seqs``
x vocab, the sampler's scratch).  :meth:`StepGraph.graph_bytes` reads
both per pools key (``nbytes`` of each entry: the static inputs' bytes
plus the capture's growth of ``torch.cuda.memory_reserved``); the pools
themselves are the batcher's, not the graph's.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List

import torch

from apex_tpu_torch.ops.common import add_launch_counts, launch_counts

__all__ = ["StepGraph", "count_delta"]


def count_delta(before: Dict[str, int], after: Dict[str, int]
                ) -> Dict[str, int]:
    """The launches counted between two :func:`launch_counts` readings."""
    return {name: n - before.get(name, 0) for name, n in after.items()
            if n != before.get(name, 0)}


def _flat(args) -> List[torch.Tensor]:
    out = []
    for a in args:
        out.extend(a.values() if isinstance(a, dict) else [a])
    return out


class _Entry:
    def __init__(self, graph, static_args, outputs, launches, nbytes):
        self.graph = graph
        self.static_args = static_args
        self.outputs = outputs
        self.launches = launches
        #: the static inputs' bytes plus the capture's private pool
        self.nbytes = nbytes


def _forget(graphs: Dict[Any, "_Entry"], pools_key) -> None:
    """Drop the graphs over pools that no longer exist."""
    for key in [k for k in graphs if k[0] == pools_key]:
        del graphs[key]


class StepGraph:
    """``step`` replayed as one CUDA graph per (pools, signature) (module
    docstring).  Call it as the step; ``step`` itself stays the eager
    path."""

    def __init__(self, step: Callable):
        self.step = step
        #: (pools key, signature) -> captured graph
        self._graphs: Dict[Any, _Entry] = {}
        self._stream = None
        #: captures made and replays run (for the tests and the smoke run)
        self.captures = 0
        self.replays = 0

    @staticmethod
    def _signature(args) -> tuple:
        return tuple(
            tuple((k, tuple(t.shape), t.dtype) for k, t in a.items())
            if isinstance(a, dict) else (tuple(a.shape), a.dtype)
            for a in args)

    @staticmethod
    def pools_key(pools: Dict[str, torch.Tensor]) -> tuple:
        """The identity the graphs over ``pools`` are kept under."""
        return tuple((k, t.data_ptr(), tuple(t.shape))
                     for k, t in pools.items())

    def graph_bytes(self) -> Dict[tuple, int]:
        """Bytes the live graphs hold, summed per pools key."""
        out: Dict[tuple, int] = {}
        for (pkey, _), entry in self._graphs.items():
            out[pkey] = out.get(pkey, 0) + entry.nbytes
        return out

    @torch.no_grad()
    def __call__(self, pools: Dict[str, torch.Tensor], *args):
        device = pools["k"].device
        pkey = self.pools_key(pools)
        sig = self._signature(args)
        entry = self._graphs.get((pkey, sig))
        if entry is None:
            return self._warm_and_capture((pkey, sig), device, pools, args)
        for static, given in zip(_flat(entry.static_args), _flat(args)):
            if given is not static:
                static.copy_(given)
        entry.graph.replay()
        add_launch_counts(entry.launches)
        self.replays += 1
        return (pools,) + entry.outputs

    def _warm_and_capture(self, key, device, pools, args):
        current = torch.cuda.current_stream(device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        side = self._stream
        dev_args = [{k: t.to(device) for k, t in a.items()}
                    if isinstance(a, dict) else a.to(device) for a in args]
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.step(pools, *dev_args)
        current.wait_stream(side)
        for t in _flat(out[1:]):
            t.record_stream(current)
        # the static inputs: the call's tensors, copied
        static_args = [{k: t.clone() for k, t in a.items()}
                       if isinstance(a, dict) else a.clone()
                       for a in dev_args]
        graph = torch.cuda.CUDAGraph()
        on_card = device.type == "cuda"
        reserved = torch.cuda.memory_reserved(device) if on_card else 0
        before = launch_counts()
        # capture_begin/end, not ``torch.cuda.graph``: that context also
        # synchronizes and empties the allocator's cache, and the next
        # prefill would then pay cudaMalloc for its activations again
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                captured = self.step(pools, *static_args)
                carry = static_args[0]
                for k, t in captured[1].items():
                    carry[k].copy_(t)
            finally:
                graph.capture_end()
        launches = count_delta(before, launch_counts())
        add_launch_counts(launches, -1)
        if all(k[0] != key[0] for k in self._graphs):
            # the first graph over these pools: they all go with the pools
            weakref.finalize(pools["k"], _forget, self._graphs, key[0])
        nbytes = sum(t.numel() * t.element_size()
                     for t in _flat(static_args))
        if on_card:
            nbytes += torch.cuda.memory_reserved(device) - reserved
        self._graphs[key] = _Entry(graph, static_args,
                                   (carry,) + tuple(captured[2:]), launches,
                                   nbytes)
        self.captures += 1
        return out
