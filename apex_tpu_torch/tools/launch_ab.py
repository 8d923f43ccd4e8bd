"""Time what a kernel launch costs the host in two or more source trees
(a parent commit and its change), on one card.

    python -m apex_tpu_torch.tools.launch_ab <tree> [<tree> ...]

Each tree is a checkout of the repository (``git archive <commit> | tar
-x -C <dir>``), timed in a process of its own in the order given
(parent, change, change, parent reads the card's drift).  The first tree
builds every CUDA source; its libraries are copied into the others'
``apex_tpu_torch/_build/`` where they lack them (a library's name holds
the hash of its source and flags, so a tree loads only a build of its
own source).  For each tree, one JSON line:

- ``count_launch_ns``: one ``ops.common.count_launch`` call, with the
  context it returns entered where it returns one, with no profiler
  running (the median of 5 loops of 100000 calls);
- ``step_ms``: the flagship O5 train step (vocab 32768, 12 layers,
  hidden 1024, 8 heads, 8 x 1024 tokens, remat, ``FusedAdam`` with fp32
  masters), wall ms a step over 20 steps after 3, each step's loss read
  back at the end (the median of 3 such runs);
- ``library_s``: the wall seconds of that tree's ``chip_smoke.py``
  ``library`` phase (the layer library on the card).

Then the card's name and power limit.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

_TIMER = r"""
import json
import statistics
import sys
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.ops import common
from apex_tpu_torch.optimizers import FusedAdam

common.build(common.KERNEL_SOURCES)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)


def launch_ns(n=100000):
    t0 = time.perf_counter()
    for _ in range(n):
        ctx = common.count_launch("launch_ab_probe")
        if ctx is not None:
            with ctx:
                pass
    return (time.perf_counter() - t0) / n * 1e9


def step_ms(steps=20, warmup=3):
    model = GPTModel(GPTConfig(
        vocab_size=32768, num_layers=12, hidden_size=1024,
        num_attention_heads=8, max_position_embeddings=1024,
        policy=get_policy("O5"), remat=True), device=dev, seed=0)
    opt = FusedAdam(model.parameters(), lr=1e-4, master_weights=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, 32768, (8, 1024), device=dev, generator=gen)
    targets = torch.roll(tokens, -1, dims=1)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(tokens, targets)
        loss.backward()
        opt.step()
        return loss.detach()

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        losses = [step() for _ in range(steps)]
        torch.stack(losses).tolist()
        runs.append((time.perf_counter() - t0) / steps * 1e3)
    return statistics.median(runs), runs


ns = statistics.median(launch_ns() for _ in range(5))
ms, runs = step_ms()
t0 = time.perf_counter()
cs.phase_library(dev)
library_s = time.perf_counter() - t0
print("LAUNCH_AB " + json.dumps({
    "count_launch_ns": round(ns, 1), "step_ms": round(ms, 3),
    "step_runs_ms": [round(r, 3) for r in runs],
    "library_s": round(library_s, 2)}), flush=True)
"""


def share_build(first: Path, tree: Path) -> None:
    """Copy the first tree's libraries into ``tree``'s build directory,
    each where ``tree`` has no file of that name."""
    src = first / "apex_tpu_torch" / "_build"
    dst = tree / "apex_tpu_torch" / "_build"
    dst.mkdir(parents=True, exist_ok=True)
    for lib in src.glob("*.so"):
        if not (dst / lib.name).exists():
            shutil.copy2(lib, dst / lib.name)


def main(argv=None) -> None:
    trees = [Path(t).resolve() for t in
             (sys.argv[1:] if argv is None else argv)]
    if not trees:
        raise SystemExit("usage: python -m apex_tpu_torch.tools.launch_ab "
                         "<tree>...")
    for i, tree in enumerate(trees):
        if i:
            share_build(trees[0], tree)
        out = subprocess.run([sys.executable, "-c", _TIMER], cwd=tree,
                             capture_output=True, text=True)
        line = [x for x in out.stdout.splitlines()
                if x.startswith("LAUNCH_AB ")]
        if out.returncode != 0 or not line:
            raise SystemExit(f"{tree}: exit {out.returncode}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        print(f"{tree.name} {line[-1][len('LAUNCH_AB '):]}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


if __name__ == "__main__":
    main()
