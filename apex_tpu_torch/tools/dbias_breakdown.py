"""Where a trained bias's backward spends its time: each rung's backward
entry with ``bias_grad=True`` (the dQ kernel's DBIAS instance, the
zero-fill of its ``(b*h, sq, sk)`` fp32 output and the fold into the
bias's shape) beside the same call without it (the BIAS instance).

    python -m apex_tpu_torch.tools.dbias_breakdown

The shapes are those ``chip_smoke.py`` times its dBias records at (bf16,
causal): the short rung at b=32 h=16 s=256 d=64 with a (1, h, s, s) bias,
the mid rung at b=8 h=8 s=1024 d=128 with a shared (s, s) bias and with a
per-batch (b, 1, s, s) one, the flash dQ entry at b=2 h=8 s=4096 d=128
with a (1, h, s, s) bias.  For each: device ms per call from a CUDA graph
of ``iters`` calls, without and with dBias alternated (without, with,
with, without, so the card's drift shows), then each kernel's device time
per call from ``torch.profiler`` over ten calls of each.  First, the
registers a thread and the spill stores that ``ptxas`` reports for every
bf16 dQ instance with a bias (the template's SEGS, DROP, BIAS and DBIAS
flags).  Last, the card's name and power limit.
"""

from __future__ import annotations

import re
import subprocess

import torch

# ptxas -v: "Compiling entry function '<symbol>'", then its "Used N
# registers" and "N bytes spill stores" lines
_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores")
# a bf16 dQ instance's template arguments: <bf16, D, SEGS, DROP, BIAS, DBIAS>
_DQ = re.compile(r"(attn_bwd_dq_kernel|flash_bwd_dq_kernel)"
                 r"I13__nv_bfloat16Li(\d+)E" + r"Lb([01])E" * 4)
# the Hopper dQ kernel of attention_bwd_sm90.cuh (bf16 only): <D, NC, SEGS,
# DROP, BIAS, DBIAS>
_DQ_SM90 = re.compile(r"sm90\w*?(bwd_dq_kernel)ILi(\d+)ELi\d+E"
                      + r"Lb([01])E" * 4)


def dq_registers(logs: dict) -> list:
    """``(source, kernel, d, flags, registers, spill bytes)`` of every bf16
    dQ instance with a bias in the ``nvcc`` outputs ``logs``."""
    rows = []
    for source, text in sorted(logs.items()):
        entry, regs, spill = None, None, None
        for line in text.splitlines():
            m = _ENTRY.search(line)
            if m:
                entry = _DQ.search(m.group(1)) or _DQ_SM90.search(
                    m.group(1))
                regs, spill = None, None
            elif entry is not None:
                m, n = _REGS.search(line), _SPILL.search(line)
                regs = int(m.group(1)) if m else regs
                spill = int(n.group(1)) if n else spill
            if entry is None or regs is None or spill is None:
                continue
            kernel, d, *flags = entry.groups()
            if flags[2] == "1":
                on = "+".join(n for n, f in zip(
                    ("SEGS", "DROP", "BIAS", "DBIAS"), flags) if f == "1")
                rows.append((source, kernel, int(d), on, regs, spill))
            entry = None
    return rows


def device_ms(fn, iters: int) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph,
    replayed once after a warm-up, between two CUDA events."""
    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 10) -> list:
    """``(ms per call, kernel)`` of every kernel ``fn`` launches, from
    ``torch.profiler`` over ``iters`` calls, largest first."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            rows.append((t / 1e3 / iters, name.split("(")[0][:110]))
    return sorted(rows, reverse=True)


#: (label, rung, b, heads, s, d, the bias's leading dims)
CASES = (
    ("short b=32 h=16 s=256 d=64, bias (1, h, s, s)", "short", 32, 16, 256,
     64, (1, 16)),
    ("mid b=8 h=8 s=1024 d=128, shared bias (s, s)", "mid", 8, 8, 1024, 128,
     ()),
    ("mid b=8 h=8 s=1024 d=128, per-batch bias (b, 1, s, s)", "mid", 8, 8,
     1024, 128, (8, 1)),
    ("flash b=2 h=8 s=4096 d=128, bias (1, h, s, s)", "flash", 2, 8, 4096,
     128, (1, 8)),
)


def backward_call(rung, b, h, s, d, lead, gen, dev):
    """The rung's backward entry on random bf16 inputs (and the forward's
    out and lse), causal, as a function of ``bias_grad``."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.randn(*lead, s, s, generator=gen, device=dev)
    if rung == "flash":
        q, k, v, do = (t.reshape(b * h, s, d) for t in (q, k, v, do))
        out, lse = fl.flash_fwd(q, k, v, True, heads=h, bias=bias)
        delta = fl.flash_delta(out, do)
        return lambda grad: fl.flash_bwd_dq(q, k, v, do, lse, delta, True,
                                            heads=h, bias=bias,
                                            bias_grad=grad)
    fwd, bwd = ((short.short_fwd, short.short_bwd) if rung == "short"
                else (mid.mid_fwd, mid.mid_bwd))
    out, lse = fwd(q, k, v, True, bias=bias)
    return lambda grad: bwd(q, k, v, out, do, lse, None, True, bias=bias,
                            bias_grad=grad)


def main() -> None:
    from apex_tpu_torch.ops import common

    logs = common.build(["attention_short", "attention_mid",
                         "attention_flash"])
    print("bf16 dQ instances with a bias (ptxas): registers a thread, "
          "spill stores")
    for source, kernel, d, flags, regs, spill in dq_registers(logs):
        print(f"  {source} {kernel} d={d} {flags}: {regs} registers, "
              f"{spill} bytes of spill stores")
    if not logs:
        print("  (no ptxas output: the sources were built already)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, rung, *shape in CASES:
        call = backward_call(rung, *shape, gen, dev)
        without, with_ = (lambda: call(False)), (lambda: call(True))
        iters = 10 if rung == "flash" else 50
        a1, b1 = device_ms(without, iters), device_ms(with_, iters)
        b2, a2 = device_ms(with_, iters), device_ms(without, iters)
        print(f"{label}: without dBias {a1:.4f} {a2:.4f} ms, with dBias "
              f"{b1:.4f} {b2:.4f} ms ({(b1 + b2) / (a1 + a2):.3f}x)")
        for name, fn in (("without", without), ("with", with_)):
            rows = kernel_ms(fn)
            print(f"  {name} dBias, {sum(t for t, _ in rows):.4f} ms of "
                  "kernels a call:")
            for t, kernel in rows:
                print(f"    {t:.4f} ms  {kernel}")
        del call, without, with_
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
