"""Time the dequant-matmul kernels of one source tree, so two trees (a
parent commit and its change) can be compared on one card.

    python -m apex_tpu_torch.tools.dequant_ab <tree> [<tree> ...]
    python -m apex_tpu_torch.tools.dequant_ab --tiles <tree>

Each tree is a checkout of the repository (``git archive <commit> | tar
-x -C <dir>``); each is timed in a process of its own, in the order
given (parent, change, change, parent reads the card's drift), with its
own build of ``csrc/dequant_matmul.cu``.  The shapes are PERF.md's, the
flagship's projections (k, n) with bf16 x, weight block 128: qkv
(1024, 3072), attn_proj (1024, 1024), fc1 (1024, 4096) and fc2 (4096,
1024) at the decode step's m = 4; fc1 at a 512-token prefill; qkv and
fc2 at serve-quant-long's 2304 tokens; and qkv at m = 36 (4 slots of
``offramp_tree(4)``'s 9 rows) and fc1 at m = 256 (a 256-token chunk).
``dequant_int8`` and ``dequant_int4`` at each, and ``torch.matmul`` on the
dense bf16 weight (the time the quantized pool has to beat).  Device ms
per call from a CUDA graph of 50 launches after a warm-up; at the decode
step's m = 4 also the eager ms per call (500 calls issued from Python,
as the serving loop issues them, the median of 5 such loops), which
holds the host's cost of a call's launches.  One line per tree, then the
card's name and power limit.

``--tiles`` times the wgmma kernel of one tree at the prefill shapes with
each token tile of ``WGMMA_TILES`` forced (no k split), the data behind
the plan's cost model.

``--one-pass`` holds the wgmma kernel of one tree, and of a copy of it
(in a temporary directory) whose kernel drops the ``w_lo`` products, so
that it computes ``x . bf16(w)``, to ``chip_smoke.py``'s two checks of a
bf16 result at the prefill shapes: the tolerance and the share of
outputs off the plain version.  The copy must fail the second.

    python -m apex_tpu_torch.tools.dequant_ab --one-pass <tree>
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

_TIMER = r"""
import importlib
import sys
sys.path.insert(0, ".")
import torch
from apex_tpu_torch.ops import common

dq = importlib.import_module("apex_tpu_torch.ops.dequant_matmul")
common.build(["dequant_matmul"])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)


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


SHAPES = (("qkv", 4, 1024, 3072), ("attn_proj", 4, 1024, 1024),
          ("fc1", 4, 1024, 4096), ("fc2", 4, 4096, 1024),
          ("qkv", 36, 1024, 3072), ("fc1", 256, 1024, 4096),
          ("fc1", 512, 1024, 4096), ("qkv", 2304, 1024, 3072),
          ("fc2", 2304, 4096, 1024))


def operands(m, k, n):
    w = torch.randn(k, n, generator=gen, device=dev) * 0.02
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    pools = {}
    for wd in ("int8", "int4"):
        pool = dq.quantize_weight(w, wd, 128)
        pools[wd] = (pool["q8" if wd == "int8" else "q4"], pool["scales"])
    return x, w.to(torch.bfloat16), pools


if MODE == "one-pass":
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, m, k, n in SHAPES:
        if m <= 8:
            continue
        w = torch.randn(k, n, generator=gen, device=dev) * 0.02
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        for wd in ("int8", "int4"):
            pool = dq.quantize_weight(w, wd, 128)
            q, s = pool["q8" if wd == "int8" else "q4"], pool["scales"]
            got = dq.dequant_matmul(x, q, s, weight_dtype=wd)
            want = dq.dequant_matmul_reference(x, q, s, weight_dtype=wd,
                                               block_size=128)
            err, tol = cs.max_err(got, want), cs.tolerance(want)
            flips = cs.bf16_flips(got, want)
            print(f"{name} m={m} {wd}: max_abs_err {err:.3g} (tolerance "
                  f"{tol:.3g}: {'held' if err <= tol else 'missed'}); "
                  f"{flips:.3%} of the outputs off the plain version "
                  f"(limit {cs.DEQUANT_FLIP_LIMIT:.0%}: "
                  f"{'held' if flips < cs.DEQUANT_FLIP_LIMIT else 'missed'})",
                  flush=True)
elif MODE == "tiles":
    plan_of = dq.dequant_plan
    for name, m, k, n in SHAPES:
        if m <= 8:
            continue
        x, wb, pools = operands(m, k, n)
        parts = [f"dense {device_ms(lambda: torch.matmul(x, wb)):.4f}"]
        for tile in dq.WGMMA_TILES:
            def plan(*args, tile=tile):
                p = plan_of(*args)
                kc = -(-k // 64) * 64
                return p._replace(tile=tile, kc=kc, splits=1,
                                  grid=(p.grid[0], -(-m // tile), 1),
                                  workspace=0, counters=0)
            dq.dequant_plan = plan
            for wd, (q, s) in pools.items():
                parts.append(f"{wd} tile {tile} {device_ms(lambda: dq.dequant_matmul(x, q, s, weight_dtype=wd)):.4f}")
            dq.dequant_plan = plan_of
        print(f"{name} m={m}: " + "; ".join(parts), flush=True)
else:
    parts = []
    for name, m, k, n in SHAPES:
        x, wb, pools = operands(m, k, n)
        row = []
        for wd, (q, s) in pools.items():
            call = lambda: dq.dequant_matmul(x, q, s, weight_dtype=wd)
            row.append(f"{wd} {device_ms(call):.4f}"
                       + (f" (eager {eager_ms(call):.4f})" if m <= 8 else ""))
        row.append(f"dense {device_ms(lambda: torch.matmul(x, wb)):.4f}")
        parts.append(f"{name} m={m}: " + " ".join(row))
    print("; ".join(parts) + " ms", flush=True)
"""


#: the wgmma kernel's w_lo products, the line ``--one-pass`` drops
_LO_PASS = "        wgmma<N>(acc, fl[h][j], dx + 2 * (s0 + j));\n"


def _one_pass_copy(tree: str, into: str) -> str:
    """A copy of ``tree`` under ``into`` whose wgmma kernel drops the
    ``w_lo`` products."""
    copy = os.path.join(into, "one-pass")
    shutil.copytree(tree, copy, ignore=shutil.ignore_patterns(
        "_build", ".git", "__pycache__", "chiprun_out"))
    src = os.path.join(copy, "apex_tpu_torch", "csrc", "dequant_matmul.cu")
    with open(src) as f:
        text = f.read()
    if text.count(_LO_PASS) != 1:
        sys.exit(f"{src}: the w_lo products are not one line of the source")
    with open(src, "w") as f:
        f.write(text.replace(_LO_PASS, ""))
    return copy


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    mode = "ab"
    if args and args[0] in ("--tiles", "--one-pass"):
        mode, args = args[0][2:], args[1:]
    if not args or (mode != "ab" and len(args) != 1):
        sys.exit("usage: python -m apex_tpu_torch.tools.dequant_ab "
                 "[--tiles | --one-pass] <tree>...")
    with tempfile.TemporaryDirectory() as tmp:
        if mode == "one-pass":
            args = args + [_one_pass_copy(args[0], tmp)]
        for tree in args:
            out = subprocess.run(
                [sys.executable, "-c", f"MODE = {mode!r}\n" + _TIMER],
                cwd=tree, capture_output=True, text=True)
            if out.returncode:
                sys.exit(f"{tree}: exit {out.returncode}\n"
                         f"{out.stderr[-2000:]}")
            print(f"{tree}:\n{out.stdout.strip()}" if mode == "one-pass"
                  else f"{tree}: {out.stdout.strip()}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
