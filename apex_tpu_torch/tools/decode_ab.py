"""Time the paged decode kernels of one source tree, so two trees (a parent
commit and its change) can be compared on one card.

    python -m apex_tpu_torch.tools.decode_ab <tree> [<tree> ...]
    python -m apex_tpu_torch.tools.decode_ab --sweep <tree>

Each tree is a checkout of the repository (``git archive <commit> | tar
-x -C <dir>``); each is timed in a process of its own, in the order
given (parent, change, change, parent reads the card's drift), with its
own build of ``csrc/attention_decode.cu``.  The shapes are PERF.md's
(h=8 d=128, pages of 64, bf16 q, NaN on the null page): ``paged_decode``
at the decode step's 4 slots of lengths 0/1/300/576 (877 tokens, 9 pages a
slot) and at serve-long's 4 x 2300 (37 pages a slot), with and without the
fused q-RoPE; ``paged_decode_int8`` (int8 pages, kv_block 128) at both;
``paged_decode_rows`` at a chunked prefill's C=256 rows at start 256 over
512 tokens (1 slot, 8 pages); ``paged_decode_tree`` at 4 slots of 877
tokens under ``offramp_tree(4)``'s 9 rows (14 pages a slot).  Device ms
per call from a CUDA graph of 50 launches after a warm-up, and (``eager``)
ms per call issued from Python, the host's cost of one call.  One line
per tree, then the card's name and power limit.

``--sweep`` times the same shapes in one tree at each span of the small
kernel (``DECODE_SPAN``) and of the many-row instance
(``DECODE_ROWS_SPAN``) and at each largest row tile (``DECODE_ROWS_TILE``)
that :data:`SWEEP` lists, and at the source's compile-time choices: the
ring's depth (``-DDECODE_STAGES``) and the blocks an SM must hold of the
many-row kernel (``-DDECODE_ROWS_MIN_BLOCKS``, its register cap), each
variant built alone by ``nvcc`` (all at once) with its registers and
spill stores printed; one line each: how the constants were chosen.
"""

from __future__ import annotations

import subprocess
import sys

_TIMER = r"""
import re
import sys
sys.path.insert(0, ".")
import torch
from apex_tpu_torch.ops import attention_decode as dec
from apex_tpu_torch.ops import common
from apex_tpu_torch.ops.quantization import quantize_rows
from apex_tpu_torch.ops.rope import rope_table
from apex_tpu_torch.serving.speculate import offramp_tree, tree_ancestors

common.build(["attention_decode"])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
H, D, PAGE = 8, 128, 64


def randn(*shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def layout(lengths, pps):
    num_pages = 1 + sum(-(-n // PAGE) for n in lengths)
    perm = torch.randperm(num_pages - 1, generator=torch.Generator()
                          .manual_seed(1)) + 1
    table = torch.zeros((len(lengths), pps), dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths):
        used = -(-n // PAGE)
        table[i, :used] = perm[at:at + used]
        at += used
    return (table.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                        device=dev), num_pages)


def device_ms(fn, iters=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, eager


def case(lengths, pps, sq, rope=False, int8=False, tree=None):
    table, lens, num_pages = layout(lengths, pps)
    if int8:
        pools = []
        for _ in range(2):
            vals, sc = quantize_rows(randn(num_pages * H * PAGE, D), 128)
            pools += [vals.view(num_pages, H, PAGE, D),
                      sc.view(num_pages, H, PAGE, 1)]
        kp, ks, vp, vs = pools
    else:
        kp, vp = (randn(num_pages, H, PAGE, D, dtype=torch.bfloat16)
                  for _ in range(2))
        kp[0] = float("nan")
        vp[0] = float("nan")
        ks = vs = None
    q = randn(len(lengths), H, sq, D, dtype=torch.bfloat16)
    tables = None
    if rope:
        cos, sin = rope_table(pps * PAGE, D, device=dev)
        pos = (lens[:, None].long() - sq
               + torch.arange(sq, device=dev)).clamp_min(0)
        tables = (cos[pos], sin[pos])
    anc = None if tree is None else tree_ancestors(tree)
    return lambda: dec.fmha_decode(q, kp, vp, table, lens, k_scales=ks,
                                   v_scales=vs, rope=tables, ancestor=anc)


SHAPES = (
    ("paged_decode 877", case([0, 1, 300, 576], 9, 1)),
    ("paged_decode 4x2300", case([2300] * 4, 37, 1)),
    ("paged_decode+rope 4x2300", case([2300] * 4, 37, 1, rope=True)),
    ("paged_decode_int8 877", case([0, 1, 300, 576], 9, 1, int8=True)),
    ("paged_decode_int8 4x2300", case([2300] * 4, 37, 1, int8=True)),
    ("paged_decode_rows C=256/512", case([512], 8, 256)),
    ("paged_decode_tree offramp(4) 4x877", case([877] * 4, 14, 9,
                                                tree=offramp_tree(4))),
)


def row(label=""):
    parts = []
    for name, fn in SHAPES:
        ms, eager = device_ms(fn)
        parts.append(f"{name} {ms:.4f}" + (f" (eager {eager:.4f})"
                                            if name == "paged_decode 877"
                                            else ""))
    print(label + "; ".join(parts) + " ms", flush=True)


def demangle(symbol):
    try:
        name = subprocess.run(["c++filt", symbol], capture_output=True,
                              text=True).stdout.strip() or symbol
    except OSError:
        return symbol
    return re.sub(r"\(anonymous namespace\)::|__nv_", "", name).split("(")[0]


if MODE == "sweep":
    import ctypes
    procs = []
    for i, (label, defines, _) in enumerate(SWEEP):
        out = common.BUILD_DIR / f"decode_sweep_{i}.so"
        procs.append((label, out, subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, *defines, "-I",
             str(common.CSRC), "-o", str(out),
             str(common.CSRC / "attention_decode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for (label, out, p), (_, _, points) in zip(procs, SWEEP):
        text, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{label}: nvcc exit {p.returncode}\n{text}")
        regs = {}
        name = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = demangle(m.group(1))
                regs[name] = [0, 0]
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name in regs:
                regs[name][1] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name in regs:
                regs[name][0] = int(m.group(1))
        print(f"[{label}] " + "; ".join(
            f"{n}: {r} regs, {sp} B spilled" for n, (r, sp) in regs.items()
            if "bfloat16" in n and "signed char" not in n), flush=True)
        lib = ctypes.CDLL(str(out))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        common._LIBS["attention_decode"] = lib
        dec._entry.cache_clear()
        for span, rows_span, tile in points:
            dec.DECODE_SPAN, dec.DECODE_ROWS_SPAN = span, rows_span
            dec.DECODE_ROWS_TILE = tile
            row(f"[{label}] span {span}, rows span {rows_span}, rows tile "
                f"{tile}: ")
else:
    row()
"""

#: the sweep: (label, nvcc defines, [(span, rows span, largest row tile)])
SWEEP = (
    ("3 stages, rows 2 blocks/SM", (),
     [(128, 128, 32), (128, 256, 32), (128, 128, 16), (128, 256, 16),
      (256, 128, 32)]),
    ("4 stages", ("-DDECODE_STAGES=4",), [(128, 128, 32), (256, 128, 32)]),
    ("2 stages", ("-DDECODE_STAGES=2",), [(128, 128, 32)]),
    ("rows 1 block/SM", ("-DDECODE_ROWS_MIN_BLOCKS=1",),
     [(128, 128, 32), (128, 256, 32)]),
)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    mode = "ab"
    if args and args[0] == "--sweep":
        mode, args = "sweep", args[1:]
    if not args or (mode == "sweep" and len(args) != 1):
        sys.exit("usage: python -m apex_tpu_torch.tools.decode_ab "
                 "[--sweep] <tree>...")
    for tree in args:
        out = subprocess.run(
            [sys.executable, "-c", f"MODE = {mode!r}\nSWEEP = {SWEEP!r}\n"
             "import subprocess\n" + _TIMER], cwd=tree,
            capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"{tree}: exit {out.returncode}\n{out.stderr[-2000:]}")
        print(f"{tree}: {out.stdout.strip()}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
