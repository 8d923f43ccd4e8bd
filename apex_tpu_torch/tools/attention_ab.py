"""Time the attention kernels of one source tree, so two trees (a parent
commit and its change) can be compared on one card.

    python -m apex_tpu_torch.tools.attention_ab <tree> [<tree> ...]

Each tree is a checkout of the repository (``git archive <commit> | tar
-x -C <dir>``); each is timed in a process of its own, in the order
given (parent, change, change, parent reads the card's drift), with its
own build of the kernels.  The shapes are the training ones without
segment ids, dropout or a bias (h=8 d=128, causal, bf16): the short
forward and backward at b=8 s=512, the mid ones at b=8 s=1024 (the
flagship's) and the flash forward, dK/dV and dQ at b=2 s=4096 (the Llama
mode's); then, with a per-batch fp32 bias and no gradient of it, the
short and mid backward and the flash dQ at the same shapes (the bias
instances of the kernels that have a dBias instance beside them); then the
three forwards' variant instances at the same shapes: with segment ids
(blocks of 150 positions), with dropout 0.1, with the per-batch bias, and
with all three; last, the short and mid backwards' variant instances at
the shapes of PERF.md's variants table: segment ids at h=16 d=64, not
causal (BERT's padding on the short rung at b=16 s=512, packed documents
on the mid rung at b=8 s=1024, ``chip_smoke.segment_ids``), dropout 0.1
at h=8 d=128 causal (b=8, s=512 and 1024), and a trained bias, the entry
with ``bias_grad=True`` (its zero-fill and fold included), causal: a (1,
h, s, s) bias at b=32 h=16 s=256 d=64 (short) and a shared (s, s) one at
b=8 h=8 s=1024 d=128 (mid); and the flash backward's two entries,
``flash_bwd_dkv`` and ``flash_bwd_dq``, with packed documents at b=2 h=16
s=4096 d=64, not causal, dropout 0.1 and a per-batch bias at b=2 h=8
s=4096 d=128, causal, and the ``flash_bwd_dq`` entry with a trained (1,
h, s, s) bias at that shape.  Device ms per call from a CUDA graph of 50
launches (10 for the flash rung) after a warm-up.  One line per tree, then
the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys

_TIMER = r"""
import sys
sys.path.insert(0, ".")
import torch
from apex_tpu_torch.ops import attention_flash as fl
from apex_tpu_torch.ops import attention_mid as mid
from apex_tpu_torch.ops import attention_short as short
from apex_tpu_torch.ops import common

common.build(["attention_short", "attention_mid", "attention_flash"])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)


def device_ms(fn, iters=50):
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


row = []
for name, s, fwd, bwd in (("short", 512, short.short_fwd, short.short_bwd),
                          ("mid", 1024, mid.mid_fwd, mid.mid_bwd)):
    q, k, v, do = (torch.randn(8, 8, s, 128, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.randn(8, 1, s, s, generator=gen, device=dev)
    out, lse = fwd(q, k, v, causal=True)
    f = device_ms(lambda: fwd(q, k, v, causal=True))
    b = device_ms(lambda: bwd(q, k, v, out, do, lse, causal=True))
    out, lse = fwd(q, k, v, causal=True, bias=bias)
    bb = device_ms(lambda: bwd(q, k, v, out, do, lse, causal=True,
                               bias=bias))
    row.append(f"{name} fwd {f:.4f} ms bwd {b:.4f} ms bwd+bias {bb:.4f} ms")
q, k, v, do = (torch.randn(16, 4096, 128, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(4))
bias = torch.randn(2, 1, 4096, 4096, generator=gen, device=dev)
out, lse = fl.flash_fwd(q, k, v, causal=True)
delta = fl.flash_delta(out, do)
f = device_ms(lambda: fl.flash_fwd(q, k, v, causal=True), 10)
dkv = device_ms(lambda: fl.flash_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=True), 10)
dq = device_ms(lambda: fl.flash_bwd_dq(q, k, v, do, lse, delta,
                                       causal=True), 10)
out, lse = fl.flash_fwd(q, k, v, causal=True, heads=8, bias=bias)
delta = fl.flash_delta(out, do)
dqb = device_ms(lambda: fl.flash_bwd_dq(q, k, v, do, lse, delta, causal=True,
                                        heads=8, bias=bias), 10)
row.append(f"flash fwd {f:.4f} ms dkv {dkv:.4f} ms dq {dq:.4f} ms "
           f"dq+bias {dqb:.4f} ms")


def variants(b, s):
    ids = (torch.arange(s, device=dev) // 150).int().expand(b, s).contiguous()
    seg = dict(q_segment_ids=ids, kv_segment_ids=ids)
    drop = dict(dropout_rate=0.1, dropout_seed=7)
    bias = dict(bias=torch.randn(b, 1, s, s, generator=gen, device=dev))
    return (("seg", seg), ("drop", drop), ("bias", bias),
            ("seg+drop+bias", {**seg, **drop, **bias}))


for name, b, s, fwd in (("short", 8, 512, short.short_fwd),
                        ("mid", 8, 1024, mid.mid_fwd)):
    q, k, v = (torch.randn(b, 8, s, 128, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    times = [f"+{tag} {device_ms(lambda: fwd(q, k, v, causal=True, **kw)):.4f}"
             for tag, kw in variants(b, s)]
    row.append(f"{name} fwd {' '.join(times)} ms")
q, k, v = (torch.randn(16, 4096, 128, generator=gen, device=dev)
           .to(torch.bfloat16) for _ in range(3))
flash_fwd = lambda kw: fl.flash_fwd(q, k, v, causal=True, heads=8, **kw)
times = [f"+{tag} {device_ms(lambda: flash_fwd(kw), 10):.4f}"
         for tag, kw in variants(2, 4096)]
row.append(f"flash fwd {' '.join(times)} ms")

import chip_smoke


def randn(*shape):
    return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)


for name, b, s, kind, fwd, bwd in (
        ("short", 16, 512, "bert", short.short_fwd, short.short_bwd),
        ("mid", 8, 1024, "docs", mid.mid_fwd, mid.mid_bwd)):
    q, k, v, do = (randn(b, 16, s, 64) for _ in range(4))
    qi, ki = chip_smoke.segment_ids(kind, b, s, dev)
    kw = dict(q_segment_ids=qi, kv_segment_ids=ki)
    out, lse = fwd(q, k, v, **kw)
    seg = device_ms(lambda: bwd(q, k, v, out, do, lse, **kw))
    b, h, d = 8, 8, 128
    s = 512 if name == "short" else 1024
    q, k, v, do = (randn(b, h, s, d) for _ in range(4))
    kw = dict(dropout_rate=0.1, dropout_seed=7)
    out, lse = fwd(q, k, v, causal=True, **kw)
    drop = device_ms(lambda: bwd(q, k, v, out, do, lse, causal=True, **kw))
    b, h, s, d, lead = ((32, 16, 256, 64, (1, 16)) if name == "short"
                        else (8, 8, 1024, 128, ()))
    q, k, v, do = (randn(b, h, s, d) for _ in range(4))
    bias = torch.randn(*lead, s, s, generator=gen, device=dev)
    out, lse = fwd(q, k, v, causal=True, bias=bias)
    dbias = device_ms(lambda: bwd(q, k, v, out, do, lse, causal=True,
                                  bias=bias, bias_grad=True))
    row.append(f"{name} bwd +seg {seg:.4f} +drop {drop:.4f} +dbias "
               f"{dbias:.4f} ms")


def flash_bwd(b, h, s, d, causal, **kw):
    q, k, v, do = (randn(b * h, s, d) for _ in range(4))
    out, lse = fl.flash_fwd(q, k, v, causal=causal, heads=h, **kw)
    delta = fl.flash_delta(out, do)
    return [device_ms(lambda: entry(q, k, v, do, lse, delta, causal=causal,
                                    heads=h, **kw), 10)
            for entry in (fl.flash_bwd_dkv, fl.flash_bwd_dq)]


qi, ki = chip_smoke.segment_ids("docs", 2, 4096, dev)
seg = flash_bwd(2, 16, 4096, 64, False, q_segment_ids=qi, kv_segment_ids=ki)
drop = flash_bwd(2, 8, 4096, 128, True, dropout_rate=0.1, dropout_seed=7)
bias_t = flash_bwd(2, 8, 4096, 128, True, bias=torch.randn(
    2, 1, 4096, 4096, generator=gen, device=dev))
q, k, v, do = (randn(16, 4096, 128) for _ in range(4))
bias = torch.randn(1, 8, 4096, 4096, generator=gen, device=dev)
out, lse = fl.flash_fwd(q, k, v, causal=True, heads=8, bias=bias)
delta = fl.flash_delta(out, do)
dbias = device_ms(lambda: fl.flash_bwd_dq(q, k, v, do, lse, delta,
                                          causal=True, heads=8, bias=bias,
                                          bias_grad=True), 10)
row.append("flash bwd " + " ".join(
    f"+{tag} dkv {t[0]:.4f} dq {t[1]:.4f}"
    for tag, t in (("seg", seg), ("drop", drop), ("bias", bias_t)))
    + f" +dbias dq {dbias:.4f} ms")
print("; ".join(row), flush=True)
"""


def main(argv=None) -> None:
    trees = sys.argv[1:] if argv is None else argv
    if not trees:
        sys.exit("usage: python -m apex_tpu_torch.tools.attention_ab <tree>...")
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", _TIMER], cwd=tree,
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
