"""Time the fleet's host offload tier against recompute for one source
tree, so two trees (a parent commit and its change) can be compared on
one card.

    python -m apex_tpu_torch.tools.offload_ab [--detail] <tree> [<tree> ...]

Each tree is a checkout of the repository (``git archive <commit> | tar
-x -C <dir>``); each is timed in a process of its own, in the order given
(parent, change, change, parent reads the host's drift), with its own
build of the kernels.  The workload is ``chip_smoke.py``'s fleet offload
run: the flagship GPT (vocab 32768, 12 layers, hidden 1024, 8 heads of
128, bf16, seed 0) on one 2-slot replica of 97 pages of 16 tokens with
chunks of 256, twelve 256-token prompts (twice the pool) served once and
then revisited with 16-token follow-ups, with a ``HostOffloadPool`` of
384 pages and without one.  For the second wave it prints the wall of
each mode, its prefill chunks, and the offload mode's host time in the
cache's eviction hook (``stage``) and in ``_fault_in`` (``fault``, less
the staging of the evictions its adoptions run), each call timed on the
host clock as the serving loop pays it.  With ``--detail`` it also times,
over both waves, ``export_pages`` (after a synchronisation, itself timed
as ``wait``) and ``import_pages`` as the batcher calls them.  One line per
tree, then the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys

_TIMER = r"""
import sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import apex_tpu_torch.serving.serve as serve
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.ops import common
from apex_tpu_torch.serving import (
    ContinuousBatcher, HostOffloadPool, KVCacheConfig, PagedKVCache,
    Request, init_pools)

DETAIL = sys.argv[1] == "1"
common.build(["attention_decode", "layer_norm", "attention_mid",
              "attention_short"])
dev = torch.device("cuda", 0)
PAGE, CHUNK, MAXP, PROMPT, SUFFIX = 16, 256, 768, 256, 16
model = GPTModel(GPTConfig(vocab_size=32768, num_layers=12, hidden_size=1024,
                           num_attention_heads=8, ffn_hidden_size=4096,
                           max_position_embeddings=1024,
                           compute_dtype=torch.bfloat16), device=dev, seed=0)
pps = -(-MAXP // PAGE)
cfg = KVCacheConfig(num_layers=12, num_heads=8, head_dim=128,
                    num_pages=1 + 2 * pps, page_size=PAGE, max_seqs=2,
                    pages_per_seq=pps, dtype=torch.bfloat16)
fns = model.decode_fns(cfg, max_prompt_len=MAXP, prefill_chunk=CHUNK)
pools = init_pools(cfg, dev)
rng = np.random.RandomState(23)
n = 2 * (cfg.num_pages - 1) // (PROMPT // PAGE)
prompts = [rng.randint(1, 32768, PROMPT).tolist() for _ in range(n)]
suffix = [rng.randint(1, 32768, SUFFIX).tolist() for _ in range(n)]

detail = {}


def timed(name, fn, wait=False):
    def call(*a):
        if wait:
            t = time.perf_counter()
            torch.cuda.synchronize()
            v = detail.setdefault("wait", [0.0, 0])
            v[0] += time.perf_counter() - t
            v[1] += 1
        t = time.perf_counter()
        out = fn(*a)
        v = detail.setdefault(name, [0.0, 0])
        v[0] += time.perf_counter() - t
        v[1] += 1
        return out
    return call


if DETAIL:
    serve.export_pages = timed("export_pages", serve.export_pages, True)
    serve.import_pages = timed("import_pages", serve.import_pages)
out = {}
for mode in ("offload", "recompute"):
    off = HostOffloadPool(4 * (cfg.num_pages - 1)) if mode == "offload" \
        else None
    b = ContinuousBatcher(fns.prefill, fns.decode, PagedKVCache(cfg), pools,
                          max_prompt_len=MAXP, harvest_every=2,
                          chunk_fn=fns.chunk, prefill_chunk=CHUNK,
                          prefix_cache=True, offload=off)
    split = {"stage": [0.0, 0], "fault": [0.0, 0]}
    active = []

    def split_call(kind, fn):
        def call(arg):
            t0 = time.perf_counter()
            active.append(kind)
            try:
                fn(arg)
            finally:
                active.pop()
            dt = time.perf_counter() - t0
            split[kind][0] += dt
            split[kind][1] += 1
            if active:
                split[active[-1]][0] -= dt
        return call

    if off is not None:
        b.cache.evict_hook = split_call("stage", b.cache.evict_hook)
        b._fault_in = split_call("fault", b._fault_in)
    for i, p in enumerate(prompts):
        b.run([Request(uid=f"w1_{i}", prompt=p, max_new_tokens=4,
                       seed=31 + i)])
    c0 = b.prefill_chunks
    for v in split.values():
        v[:] = [0.0, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        b.run([Request(uid=f"w2_{i}", prompt=p + suffix[i],
                       max_new_tokens=4, seed=71 + i)])
    torch.cuda.synchronize()
    out[mode] = (time.perf_counter() - t0, b.prefill_chunks - c0,
                 {u: c.tokens for u, c in b.completions.items()
                  if u.startswith("w2_")}, split, off)
if out["offload"][2] != out["recompute"][2]:
    sys.exit("offloaded and recomputed revisits differ")
sp, st = out["offload"][3], out["offload"][4].stats
line = (f"wave 2 offload {1e3 * out['offload'][0]:.1f} ms "
        f"({out['offload'][1]} chunks), recompute "
        f"{1e3 * out['recompute'][0]:.1f} ms ({out['recompute'][1]} chunks);"
        f" stage {1e3 * sp['stage'][0]:.1f} ms in {sp['stage'][1]} calls, "
        f"fault {1e3 * sp['fault'][0]:.1f} ms in {sp['fault'][1]} calls; "
        f"{st['offloaded']} offloaded, {st['faulted']} faulted")
if DETAIL:
    line += "; both waves: " + ", ".join(
        f"{k} {1e3 * t:.1f} ms in {c} calls" for k, (t, c) in detail.items())
print(line, flush=True)
"""


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else list(argv)
    detail = "--detail" in args
    trees = [a for a in args if a != "--detail"]
    if not trees:
        sys.exit("usage: python -m apex_tpu_torch.tools.offload_ab "
                 "[--detail] <tree>...")
    for tree in trees:
        out = subprocess.run(
            [sys.executable, "-c", _TIMER, "1" if detail else "0"],
            cwd=tree, capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"{tree}: exit {out.returncode}\n{out.stderr[-2000:]}")
        print(f"{tree}: {out.stdout.strip()}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
