"""Per-op-class report over a parsed trace: the reference's ``prof``
stage.

Counterpart of ``apex_tpu/pyprof/prof.py``.  The JAX package files XLA's
HLO opcodes; on the H100 a trace holds CUDA kernel names (cuBLAS's
``nvjet``/``sm90_xmma_gemm`` products, ATen's elementwise and reduce
kernels, cuDNN's convolutions, NCCL's collectives, copies and memsets)
and the port's own kernels, by their symbols and by the names their
launch counters use (each launch runs inside a ``record_function`` range
of that name, ``apex_tpu_torch.ops.common.count_launch``).  The classes,
their kinds and their first-match order are JAX's; only the patterns
grow, so a name of the two vocabularies files the same in both.

Typical use::

    with pyprof.trace(log_dir):
        step(...)
    rows = pyprof.parse(log_dir, plane_filter="GPU")
    classes = pyprof.prof(rows)
    print(pyprof.prof_table(classes))
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

__all__ = ["classify", "prof", "prof_table", "utilization", "OP_CLASSES"]


# Each entry: (class name, regex over the normalized op name, kind).
# kind in {"compute", "memory", "collective", "host", "other"}: the
# roofline role the class plays (tensor-core FLOPs / HBM bytes / links).
# Order matters: first match wins.  JAX's classes in JAX's order; each
# pattern adds the card's names after JAX's own.
OP_CLASSES = (
    ("flash_attention",
     r"flash|attention|\battn|\b(short|mid)_(fwd|bwd)|paged_decode|fmha|"
     r"bwd_dkv_kernel|bwd_dq_kernel", "compute"),
    ("pallas_kernel", r"pallas|custom-call|custom_call|mosaic", "compute"),
    ("gemm",
     r"\bdot|(?<!implicit_)gemm|matmul|einsum|nvjet|"
     r"\b(mm|bmm|addmm|baddbmm|linear)\b|dequant", "compute"),
    ("convolution", r"conv(?!ert)|fprop|dgrad|wgrad", "compute"),
    ("cholesky_triangular", r"cholesky|triangular", "compute"),
    ("all_reduce", r"all-reduce|all_reduce|psum|allreduce", "collective"),
    ("all_gather", r"all-gather|all_gather|allgather", "collective"),
    ("reduce_scatter", r"reduce-scatter|reduce_scatter|reducescatter",
     "collective"),
    ("all_to_all", r"all-to-all|all_to_all|alltoall", "collective"),
    ("permute", r"collective-permute|ppermute|collective_permute|sendrecv",
     "collective"),
    ("host_transfer",
     r"infeed|outfeed|host|transfer|\bsend\b|\brecv\b|htod|dtoh",
     "host"),
    ("loop_control", r"\bwhile\b|conditional|checkpoint|remat|closed_call",
     "compute"),
    ("sort", r"sort|top-k|topk", "compute"),
    ("rng", r"\brng\b|threefry|random|philox|dropout|gumbel", "compute"),
    ("slice_update", r"dynamic-slice|dynamic_slice|dynamic-update|"
     r"dynamic_update|slice|pad", "memory"),
    ("reduction", r"reduce|cumsum|cumulative|softmax", "compute"),
    # word-bound and AFTER the specific classes: select-and-scatter and
    # gather-bearing fusion names must not misfile here
    ("scatter_gather", r"(?<!and-)\bscatter\b|\bgather\b", "memory"),
    # an optimizer's l2norm is a reduction of its tail, not a norm layer
    ("normalization",
     r"(?<!l2)norm|batch-norm|batch_norm|\bln_|\bbn_", "compute"),
    ("copy_layout", r"copy|transpose|reshape|bitcast|broadcast|concat|"
     r"reverse|tuple|convert|memcpy|memset", "memory"),
    ("select_compare", r"select|compare|clamp|where|iota", "memory"),
    # long opcode forms listed explicitly; short/collision-prone tokens
    # are fully word-bounded so host frames never misfile as device work
    ("elementwise",
     r"multiply|divide|exponential|logarithm|subtract|negate|maximum|"
     r"minimum|remainder|rsqrt|sqrt|tanh|floor|ceil|sine|cosine|power|"
     r"logistic|sigmoid|gelu|relu|erf\b|"
     r"\b(add|sub|mul|div|exp|log|pow|neg|abs|max|min|and|or|xor|not|"
     r"sin|cos|sign)\b|elementwise|multi_tensor|\b(step|scale|l2norm|"
     r"l2norm_total|fold)_kernel", "memory"),
    ("fusion", r"fusion|\bcall\b", "compute"),
)

# an HLO trace event name is often the full instruction text
# ("%copy-start.5 = (bf16[8,8,1024,128]{...} ...") — the opcode is the
# LHS symbol, so classification must never look past " = "
_NORM = re.compile(r"^%?([a-zA-Z0-9_.\-]+?)(\.\d+)?$")


def classify(name: str) -> tuple:
    """-> (op_class, kind) for one kernel, operator or HLO event name."""
    base = name.strip().split(" = ", 1)[0].strip()
    m = _NORM.match(base)
    base = (m.group(1) if m else base).lower()
    for cls, pat, kind in OP_CLASSES:
        if re.search(pat, base):
            return cls, kind
    return "other", "other"


#: the trace's envelopes: ``record_function`` ranges (on the host and, as
#: Kineto's ``gpu_user_annotation``, on the device: a launch counter's
#: range spans its kernels), the profiler's ``ProfilerStep#N`` spans and
#: its own ``PyTorch Profiler (N)`` span would double-count every op
#: under them.  :func:`parse` puts annotation events on lines ending with
#: this suffix.
ANNOTATION_LINE = "(user annotations)"
_STEP_SPAN = re.compile(r"^(ProfilerStep#\d+|PyTorch Profiler \(\d+\))$")


def is_envelope(row: Dict[str, Any]) -> bool:
    """A parsed row that spans other rows (see :data:`ANNOTATION_LINE`)."""
    return (str(row.get("line", "")).endswith(ANNOTATION_LINE)
            or bool(_STEP_SPAN.match(str(row.get("name", "")))))


def prof(
    rows: List[Dict[str, Any]], include_envelopes: bool = False
) -> List[Dict[str, Any]]:
    """Aggregate :func:`apex_tpu_torch.pyprof.parse` rows into per-class
    rows, sorted by total time::

        {"op_class", "kind", "count", "ops", "total_ms", "avg_ms", "pct"}

    ``ops`` is the distinct member-op names (up to 8, by time), the
    breadcrumb back to the per-op table.  Annotation ranges and
    ``ProfilerStep#N`` spans (envelopes that would double-count every op
    under them) are dropped unless ``include_envelopes``."""
    agg: Dict[str, Dict[str, Any]] = {}
    for r in rows:
        if not include_envelopes and is_envelope(r):
            continue
        cls, kind = classify(r["name"])
        row = agg.setdefault(cls, {
            "op_class": cls, "kind": kind, "count": 0, "total_ms": 0.0,
            "_members": {},
        })
        row["count"] += r["count"]
        row["total_ms"] += r["total_ms"]
        row["_members"][r["name"]] = (
            row["_members"].get(r["name"], 0.0) + r["total_ms"]
        )
    out = sorted(agg.values(), key=lambda r: -r["total_ms"])
    total = sum(r["total_ms"] for r in out) or 1.0
    for r in out:
        members = sorted(r.pop("_members").items(), key=lambda kv: -kv[1])
        r["ops"] = [k for k, _ in members[:8]]
        r["avg_ms"] = r["total_ms"] / max(r["count"], 1)
        r["pct"] = 100.0 * r["total_ms"] / total
    return out


def _cost_numbers(costs: Dict[str, float]) -> tuple:
    """(flops, bytes accessed) from a cost dict, shared with
    :func:`apex_tpu_torch.pyprof.summarize`."""
    return (
        float(costs.get("flops", 0.0)),
        float(costs.get("bytes accessed", 0.0)),
    )


def _time_by_kind(classes: List[Dict[str, Any]]) -> Dict[str, float]:
    by_kind: Dict[str, float] = {}
    for r in classes:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["total_ms"]
    return by_kind


def prof_table(classes: List[Dict[str, Any]],
               top: Optional[int] = None) -> str:
    """Format prof() rows: the reference's per-op-class summary print."""
    lines = [
        f"{'class':<20} {'kind':<11} {'count':>7} {'total ms':>10} "
        f"{'%':>6}  top ops"
    ]
    for r in classes[:top]:
        ops = ", ".join(r["ops"][:3])
        lines.append(
            f"{r['op_class']:<20} {r['kind']:<11} {r['count']:>7} "
            f"{r['total_ms']:>10.3f} {r['pct']:>6.1f}  {ops[:60]}"
        )
    by_kind = _time_by_kind(classes)
    total = sum(by_kind.values()) or 1.0
    split = "  ".join(
        f"{k}: {100.0 * v / total:.1f}%" for k, v in
        sorted(by_kind.items(), key=lambda kv: -kv[1])
    )
    lines.append(f"-- time by kind: {split}")
    return "\n".join(lines)


def utilization(
    classes: List[Dict[str, Any]],
    costs: Dict[str, float],
    peak_flops: Optional[float] = None,
    peak_bandwidth: Optional[float] = None,
    steps: int = 1,
) -> Dict[str, Any]:
    """Marry the per-class time split with a cost count: compute/memory
    time, achieved FLOP/s and bytes/s and, with peaks given, utilization
    fractions.

    ``classes``: :func:`prof` output for a trace of ``steps`` executions
    (the device plane's rows); ``costs``:
    :func:`apex_tpu_torch.pyprof.cost_analysis` of the traced function
    (one execution).  FLOP/s are over the compute classes' time; bytes/s
    follow the roofline convention, bytes over the device time of the
    compute, memory and collective classes."""
    by_kind = _time_by_kind(classes)
    compute_s = by_kind.get("compute", 0.0) / 1e3 / max(steps, 1)
    memory_s = by_kind.get("memory", 0.0) / 1e3 / max(steps, 1)
    total_s = sum(
        by_kind.get(k, 0.0) for k in ("compute", "memory", "collective")
    ) / 1e3 / max(steps, 1)
    other_s = (
        sum(by_kind.values()) / 1e3 / max(steps, 1) - total_s
    )
    flops, bytes_accessed = _cost_numbers(costs)
    out: Dict[str, Any] = {
        "compute_ms": round(compute_s * 1e3, 3),
        "memory_ms": round(memory_s * 1e3, 3),
        "collective_ms": round(
            by_kind.get("collective", 0.0) / max(steps, 1), 3
        ),
        "total_ms": round(total_s * 1e3, 3),
        "host_other_ms": round(other_s * 1e3, 3),
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "achieved_flops_per_sec": flops / compute_s if compute_s else 0.0,
        "achieved_bytes_per_sec": (
            bytes_accessed / total_s if total_s else 0.0
        ),
    }
    if peak_flops and compute_s:
        out["compute_utilization"] = round(
            out["achieved_flops_per_sec"] / peak_flops, 4
        )
    if peak_bandwidth and total_s:
        out["bandwidth_utilization"] = round(
            out["achieved_bytes_per_sec"] / peak_bandwidth, 4
        )
    return out
