"""Time the layer norm of one source tree, so two trees (a parent commit
and its change) can be compared on one card.

    python -m apex_tpu_torch.tools.layer_norm_ab <tree> [<tree> ...]

Each tree is a checkout of the repository (``git archive <commit> | tar
-x -C <dir>``); each is timed in a process of its own, in the order
given (parent, change, change, parent reads the card's drift), with its
own build.  Hidden 1024, PERF.md's shapes: the forward
(``ops.layer_norm.layer_norm_fwd``) at 4, 512, 2304 and 8192 rows for
bf16 layer norm, bf16 RMSNorm (fp32 parameters, the O5 norms) and the
final norm's fp32 input; the backward (``layer_norm_bwd``, dx, dscale and
dbias) at 2304 and 8192 rows for the same three; each as device ms per
call from a CUDA graph of 50 calls after a warm-up.  Beside them, the
backward through autograd (``fused_layer_norm_affine`` /
``fused_rms_norm_affine`` forward + backward less the forward, device
ms summed by ``torch.profiler`` over 10 calls, as a training step runs
it), and at 4 rows the eager ms per forward call (500 calls issued from
Python, the median of 5 such loops), which holds the host's cost of a
call.  One line per tree, then the card's name and power limit.

``--train`` runs instead, for each tree in turn, that tree's own
``chip_smoke.py`` training phases with their profiles: the flagship
(phase 7, O5, 8 x 1024), the Llama mode (phase 9, 2 x 4096) and
BERT-large (bert-train), after the tree's build (phase 1); their output
(ms/step, device time by kind, launches) is printed as it comes.

    python -m apex_tpu_torch.tools.layer_norm_ab --train <tree> [<tree> ...]
"""

from __future__ import annotations

import subprocess
import sys

_TIMER = r"""
import sys
sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile
from apex_tpu_torch.ops import common
from apex_tpu_torch.ops import layer_norm as ln

if "layer_norm" in common.KERNEL_SOURCES:
    common.build(["layer_norm"])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
HIDDEN = 1024


def device_ms(fn, iters=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters=500, loops=5):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[loops // 2]


def profiled_ms(fn, iters=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = 0.0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        t = getattr(e, "self_device_time_total", None)
        busy += e.self_cuda_time_total if t is None else t
    return busy / 1e3 / iters


def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
    x = torch.randn(*shape, generator=gen, device=dev) * scale + shift
    return x.to(dtype)


CASES = (("ln bf16", torch.bfloat16, False), ("rms bf16", torch.bfloat16,
         True), ("ln fp32 x", torch.float32, False))
w = randn(HIDDEN, scale=0.1, shift=1.0)
b = randn(HIDDEN, scale=0.1)
parts = []
for label, dtype, rms in CASES:
    bias = None if rms else b
    for rows in (4, 512, 2304, 8192):
        x = randn(rows, HIDDEN, dtype=dtype, scale=3.0, shift=0.5)
        fwd = lambda: ln.layer_norm_fwd(x, w, bias, 1e-5, rms)
        row = [f"fwd {device_ms(fwd):.4f}"]
        if rows == 4:
            row.append(f"eager {eager_ms(fwd):.4f}")
        if rows >= 2304:
            dy = randn(rows, HIDDEN, dtype=dtype)
            _, mean, invvar = fwd()
            bwd = lambda: ln.layer_norm_bwd(
                dy, x, w, None if rms else b.dtype, mean, invvar, rms)
            row.append(f"bwd {device_ms(bwd):.4f}")
            xg, wg, bg = (t.detach().clone().requires_grad_()
                          for t in (x, w, b))
            leaves = (xg, wg) if rms else (xg, wg, bg)

            def call():
                if rms:
                    return ln.fused_rms_norm_affine(xg, wg, HIDDEN)
                return ln.fused_layer_norm_affine(xg, wg, bg, HIDDEN)

            def fwd_bwd():
                torch.autograd.grad(call(), leaves, dy)

            with torch.no_grad():
                f_ms = profiled_ms(call)
            row.append(f"autograd bwd {profiled_ms(fwd_bwd) - f_ms:.4f}")
        parts.append(f"{label} rows={rows}: " + " ".join(row))
print("; ".join(parts) + " ms", flush=True)
"""


_TRAIN = r"""
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
cs.phase_build()
_, tr, batch = cs.phase_train(dev)
cs.phase_profile_train(tr, batch)
del tr, batch
torch.cuda.empty_cache()
_, tr, batch = cs.phase_train(dev, cs.TRAIN_LONG, "train-long",
                              ("ln_fwd",) + cs.FLASH)
cs.phase_profile_train(tr, batch, "Llama mode (O5, 2 x 4096)")
del tr, batch
torch.cuda.empty_cache()
cs.phase_bert_train(dev)
"""


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    train = bool(args) and args[0] == "--train"
    args = args[1:] if train else args
    if not args:
        sys.exit("usage: python -m apex_tpu_torch.tools.layer_norm_ab "
                 "[--train] <tree>...")
    for tree in args:
        if train:
            print(f"{tree}:", flush=True)
            out = subprocess.run([sys.executable, "-c", _TRAIN], cwd=tree)
        else:
            out = subprocess.run([sys.executable, "-c", _TIMER], cwd=tree,
                                 capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"{tree}: exit {out.returncode}"
                     + ("" if train else f"\n{out.stderr[-2000:]}"))
        if not train:
            print(f"{tree}: {out.stdout.strip()}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
