"""The packed optimizer tail: moments and masters in flat fp32 buckets.

Counterpart of ``apex_tpu/optimizers/fused_tail.py``.  With
``fused_tail=True`` (FusedAdam, FusedLAMB) the optimizer keeps each state
tensor (``exp_avg``, ``exp_avg_sq``, ``master``) as contiguous buffers of
the bucket plan JAX uses (:func:`tail_plan`: the leaves in reverse order,
a bucket closing at ``bucket_bytes`` of fp32, named ``bucket_000``, ...),
and each parameter's state is a view into them.  The step is the same
multi-tensor launch as without (``ops/multi_tensor.py``), over views of
the buffers; with :meth:`~apex_tpu_torch.optimizers.base.FusedOptimizer.
step_scaled` the loss scaler's unscale folds into the kernel's one read
of the gradients (:func:`fold_grads` is its plain model).  The values
are the per-leaf path's, bit for bit: only the layout changes.

The port keeps its own copy of JAX's bucket plan
(``apex_tpu/parallel/overlap.py`` ``GradientBuckets.from_shapes``,
``pack``, ``unpack``), so a JAX state packed for a tree and the port's
packed for the same leaves have the same buckets.

Each packed step emits JAX's ``opt_tail`` telemetry event
(:func:`emit_opt_tail_event`: static host fields, free when no sink
listens, never a device synchronisation); :func:`time_opt_tail` emits it
with the measured ms and GB/s and returns them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.telemetry import events as _events

__all__ = [
    "DEFAULT_BUCKET_BYTES",
    "Bucket",
    "GradientBuckets",
    "TailContext",
    "tail_plan",
    "pack_tree",
    "fold_grads",
    "unpack_bufs",
    "tail_traffic_bytes",
    "emit_opt_tail_event",
    "time_opt_tail",
]

#: the bucket size of JAX's plan (``apex_tpu/parallel/overlap.py``)
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _leaf_size(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One bucket: its leaves (by index in the flat list), their element
    counts, the buffer's dtype."""

    leaf_ids: Tuple[int, ...]
    sizes: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def size(self) -> int:
        return sum(self.sizes)


class GradientBuckets:
    """A deterministic bucket plan over a list of leaves: every leaf in
    exactly one bucket, the leaves taken in REVERSE order, a bucket closing
    when the next leaf would push it past ``bucket_bytes`` or the dtype
    changes (a leaf larger than that gets a bucket of its own).  The port's
    copy of ``apex_tpu.parallel.overlap.GradientBuckets`` at world size 1
    (no model axes)."""

    def __init__(self, buckets: Sequence[Bucket], n_leaves: int):
        if not buckets and n_leaves:
            raise ValueError("empty bucket plan for a non-empty tree")
        seen = [i for b in buckets for i in b.leaf_ids]
        if sorted(seen) != list(range(n_leaves)):
            raise ValueError("bucket plan must cover every leaf exactly once")
        self.buckets = tuple(buckets)
        self.n_leaves = n_leaves

    @classmethod
    def from_shapes(cls, shapes: Sequence[Sequence[int]],
                    dtypes: Sequence[torch.dtype],
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES
                    ) -> "GradientBuckets":
        if bucket_bytes < 1:
            raise ValueError("bucket_bytes must be >= 1")
        buckets: List[Bucket] = []
        ids: List[int] = []
        sizes: List[int] = []
        cur_dtype, cur_bytes = None, 0
        for i in reversed(range(len(shapes))):
            dt = dtypes[i]
            size = _leaf_size(shapes[i])
            nbytes = size * _itemsize(dt)
            if ids and (dt != cur_dtype or cur_bytes + nbytes > bucket_bytes):
                buckets.append(Bucket(tuple(ids), tuple(sizes), cur_dtype))
                ids, sizes, cur_bytes = [], [], 0
            ids.append(i)
            sizes.append(size)
            cur_dtype = dt
            cur_bytes += nbytes
        if ids:
            buckets.append(Bucket(tuple(ids), tuple(sizes), cur_dtype))
        return cls(buckets, len(shapes))

    @property
    def names(self) -> List[str]:
        return [f"bucket_{i:03d}" for i in range(len(self.buckets))]

    def pack(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each bucket's leaves (in its order) flattened into one buffer of
        the bucket's dtype."""
        if len(leaves) != self.n_leaves:
            raise ValueError(f"plan covers {self.n_leaves} leaves, got "
                             f"{len(leaves)}")
        return [torch.cat([leaves[i].reshape(-1).to(b.dtype)
                           for i in b.leaf_ids]) for b in self.buckets]

    def unpack(self, bufs: Sequence[torch.Tensor],
               like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The buffers sliced back into leaves shaped and typed like
        ``like`` (the inverse of :meth:`pack`)."""
        out: List[Optional[torch.Tensor]] = [None] * self.n_leaves
        for b, buf in zip(self.buckets, bufs):
            off = 0
            for i, size in zip(b.leaf_ids, b.sizes):
                out[i] = buf[off:off + size].reshape(like[i].shape).to(
                    like[i].dtype)
                off += size
        return out


def tail_plan(params: Sequence[Any],
              bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> GradientBuckets:
    """The plan the fused tail packs state into: fp32 buffers over the
    leaves' shapes (tensors or shapes), in JAX's order."""
    shapes = [tuple(p.shape) if hasattr(p, "shape") else tuple(p)
              for p in params]
    return GradientBuckets.from_shapes(shapes, [torch.float32] * len(shapes),
                                       bucket_bytes)


def pack_tree(plan: GradientBuckets, leaves: Sequence[torch.Tensor],
              dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The leaves (in list order) packed into the plan's named buffers."""
    bufs = plan.pack([l.detach().to(dtype) for l in leaves])
    return dict(zip(plan.names, bufs))


def unpack_bufs(plan: GradientBuckets, bufs: Dict[str, torch.Tensor],
                like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Named buffers sliced back into leaves shaped and typed like
    ``like``."""
    return plan.unpack([bufs[n] for n in plan.names], like)


def fold_grads(leaves: Sequence[torch.Tensor],
               inv_scale: Optional[torch.Tensor] = None):
    """Per-leaf fp32 gradients with the scaler's unscale, and the finite
    flag of the incoming (still scaled) values: ``(list, finite)``.  The
    unscale takes JAX's round trip through the gradient's dtype,
    ``(g * inv).astype(g.dtype).astype(f32)``, which is what the step
    kernels compute in their one read of each gradient; this function is
    that fold's model, for tests and reading (the step does not call
    it).  On the card it launches ``multi_tensor_scale``."""
    leaves = list(leaves)
    finite = mt.scale(leaves) if leaves else torch.ones((), dtype=torch.bool)
    if inv_scale is None:
        return [g.float() for g in leaves], finite
    out = [torch.empty_like(g) for g in leaves]
    if leaves:
        mt.scale(leaves, inv_scale, out=out)
    return [g.float() for g in out], finite


@dataclasses.dataclass
class TailContext:
    """The plan and the leaf shapes, and the view/pack pair between the
    buffers and the leaves."""

    plan: GradientBuckets
    shapes: tuple

    def views(self, bufs: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf as a view of its bucket, in the leaf's shape."""
        out: List[Optional[torch.Tensor]] = [None] * self.plan.n_leaves
        for b, name in zip(self.plan.buckets, self.plan.names):
            buf, off = bufs[name], 0
            for i, size in zip(b.leaf_ids, b.sizes):
                out[i] = buf[off:off + size].view(self.shapes[i])
                off += size
        return out

    def pack_views(self, views: Sequence[torch.Tensor],
                   dtype: torch.dtype = torch.float32
                   ) -> Dict[str, torch.Tensor]:
        return {name: torch.cat([views[i].reshape(-1).to(dtype)
                                 for i in b.leaf_ids])
                for b, name in zip(self.plan.buckets, self.plan.names)}

    def global_norm(self, views: Sequence[torch.Tensor]) -> torch.Tensor:
        """The L2 norm over the views (``multi_tensor_l2norm``'s order)."""
        return mt.l2norm(list(views)).total


def tail_traffic_bytes(params: Sequence[torch.Tensor], opt) -> int:
    """Device bytes one fused tail step moves: read the gradients and the
    moments (and the masters), write the parameters and the moments (and
    the masters), with the gradients in the parameters' dtype."""
    total = 0
    master = bool(getattr(opt, "master_weights", False))
    v_item = _itemsize(getattr(opt, "exp_avg_sq_dtype", torch.float32))
    for p in params:
        n, item = p.numel(), p.element_size()
        total += 2 * n * item + 2 * n * 4 + 2 * n * v_item
        total += 2 * n * 4 if master else n * item
    return total


def emit_opt_tail_event(opt, plan: GradientBuckets, *,
                        unscale_folded: bool,
                        self_ms: Optional[float] = None,
                        gbs: Optional[float] = None) -> None:
    """The ``opt_tail`` telemetry event of one packed step: the static
    shape of the pass (host fields only), with ``self_ms``/``gbs`` where
    :func:`time_opt_tail` measured them.  Free when no sink listens."""
    if not _events.have_sinks():
        return
    total = sum(b.size for b in plan.buckets)
    moment = getattr(opt, "exp_avg_sq_dtype", None) or torch.float32
    fields = dict(
        fused=True,
        buffers=len(plan.buckets),
        elements=int(total),
        buffer_bytes=int(total) * 4,
        moment_dtype=str(moment).replace("torch.", ""),
        master_weights=bool(getattr(opt, "master_weights", False)),
        unscale_folded=bool(unscale_folded),
    )
    if self_ms is not None:
        fields["self_ms"] = round(float(self_ms), 4)
    if gbs is not None:
        fields["gbs"] = round(float(gbs), 2)
    _events.emit("opt_tail", **fields)


def time_opt_tail(opt, inv_scale: Optional[torch.Tensor] = None,
                  iters: int = 10, warmup: int = 2) -> dict:
    """Time the optimizer's step on its current gradients (``step`` or,
    with ``inv_scale``, ``step_scaled``): ``warmup`` + ``iters`` steps,
    which update the parameters.  ``{"ms", "bytes", "gbs"}``: ms a step
    (CUDA events on the card, the host clock on the CPU), the bytes of
    :func:`tail_traffic_bytes` and the rate they imply."""
    params = [p for g in opt.param_groups for p in g["params"]
              if p.grad is not None]
    run = (opt.step if inv_scale is None
           else lambda: opt.step_scaled(inv_scale))
    for _ in range(warmup):
        run()
    cuda = bool(params) and params[0].is_cuda
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        ms = (time.perf_counter() - t0) / iters * 1e3
    nbytes = tail_traffic_bytes(params, opt)
    gbs = nbytes / (ms * 1e-3) / 1e9 if ms > 0 else 0.0
    if getattr(opt, "fused_tail", False):
        emit_opt_tail_event(opt, opt._ensure_tail().plan,
                            unscale_folded=inv_scale is not None,
                            self_ms=ms, gbs=gbs)
    return {"ms": ms, "bytes": nbytes, "gbs": gbs}
