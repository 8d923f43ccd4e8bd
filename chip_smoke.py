"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit, and no result line):

1. build   — compile the CUDA kernels under ``apex_tpu_torch/csrc``
             (one ``nvcc`` per source, all at once) and print the card's
             name and power limit as ``nvidia-smi`` reports them.
2. kernels — hold each hand-written kernel against its plain PyTorch
             version on the card, at the serving path's shapes, in bf16
             and fp32; print each one's error, time, bound and the time
             of a PyTorch library call for the same function, if any.
3. parity  — the flagship GPT's width at 2 layers, fp32 compute: the
             paged greedy tokens of ``ContinuousBatcher`` (6 ragged
             requests, 2 slots, 16 new tokens) must equal the port's
             full-recompute ``generate_reference`` token for token.
4. serve   — the full flagship GPT (12 layers, bf16): 8 requests with
             prompts of 32..512 tokens, 32 greedy tokens each, through
             ``decode_fns`` + ``ContinuousBatcher``; every request must
             complete, and every kernel must have launched in this phase;
             the bf16 logits are printed beside the same weights at fp32.
5. profile — the same model under ``torch.profiler``: four prefills,
             then one harvest window of decode steps; the device's busy
             share and the kernels that took its time.

The last two lines are a JSON object with one record per kernel, and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# operation rates of the types these kernels compute in
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the flagship GPT (bench.py FLAGSHIP): vocab 32768, 12 layers, hidden
# 1024, 8 heads (head_dim 128), ffn 4096, learned positions up to 1024
FLAGSHIP = dict(vocab_size=32768, num_layers=12, hidden_size=1024,
                num_attention_heads=8, ffn_hidden_size=4096,
                max_position_embeddings=1024)


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def tolerance(ref: torch.Tensor) -> float:
    """Kernel-vs-plain tolerance on the same inputs.  fp32: 1e-4 of the
    output's scale (both compute in fp32; only the order of the sums
    differs).  bf16: two bf16 ulps at the output's largest magnitude
    (both round fp32 values to bf16, which may fall on either side of
    a rounding boundary; the tensor-core kernels also round the
    probabilities to bf16 before P.V)."""
    top = ref.float().abs().max().item()
    if ref.dtype == torch.float32:
        return 1e-4 * max(1.0, top)
    return 2.0 * bf16_ulp(top)


def _events_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 50) -> tuple:
    """``(device_ms, eager_ms)`` of one call, from CUDA events after a
    warm-up.  ``device_ms`` replays ``iters`` calls captured in one CUDA
    graph, so it is the device's time without the host's launch cost;
    ``eager_ms`` issues the calls from Python as the serving loop does,
    so for a small kernel it is the host's launch rate."""
    def loop():
        for _ in range(iters):
            fn()            # results dropped: one output buffer in use

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    eager = _events_ms(loop, iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, iters), eager


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, got, want, what: str) -> float:
    err = max_err(got, want)
    tol = tolerance(want)
    if not math.isfinite(err) or err > tol:
        fail(f"{name} {what}: max |kernel - plain| = {err:.3g} > "
             f"tolerance {tol:.3g}")
    log(f"  {name} {what}: max_abs_err {err:.3g} (tolerance {tol:.3g})")
    return err


def measure(name, shape, err, kernel, plain, library, *, nbytes, ops,
            dtype) -> dict:
    """Time a kernel, its plain version and (``(label, fn)`` or None) the
    PyTorch call that computes the same function; the bound is the
    larger of ``nbytes`` over the memory rate and ``ops`` over the peak
    rate of ``dtype``."""
    ms, eager = time_ms(kernel)
    plain_ms, _ = time_ms(plain)
    lib_ms = time_ms(library[1])[0] if library else None
    bnd, by = bound_ms(nbytes, ops, dtype)
    lib_txt = f"{library[0]} {lib_ms:.4f} ms" if library else "no library call"
    log(f"  {name} {shape}: {ms:.4f} ms on the device ({eager:.4f} ms per "
        f"eager call), plain {plain_ms:.4f} ms, {lib_txt}, bound "
        f"{bnd:.5f} ms ({by})")
    return dict(shape=shape, max_abs_err=err, ms=ms, eager_ms=eager,
                plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms)


# ---------------------------------------------------------------- phase 1
def phase_build() -> str:
    from apex_tpu_torch.ops import common

    t0 = time.perf_counter()
    logs = common.build()
    log(f"[build] {len(logs)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f} s: {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    return card


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev) -> dict:
    from apex_tpu_torch.ops import attention_decode as dec
    from apex_tpu_torch.ops import attention_short as short
    from apex_tpu_torch.ops import layer_norm as ln
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.randn(*shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    records = {}
    hidden = FLAGSHIP["hidden_size"]
    heads = FLAGSHIP["num_attention_heads"]
    d = hidden // heads

    # -- layer norm: decode rows (4 slots) and prefill rows (512) -------
    log("[kernels] ln_fwd (Triton), hidden 1024")
    w = randn(hidden, scale=0.1, shift=1.0)
    b = randn(hidden, scale=0.1)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 512):
            x = randn(rows, hidden, dtype=dtype, scale=3.0, shift=0.5)
            got = ln.layer_norm_fwd(x, w, b, 1e-5, rms=False)
            want = ln._ln_fwd_plain(x, w, b, 1e-5, rms=False)
            err = check("ln_fwd", got[0], want[0],
                        f"{str(dtype)[6:]} rows={rows} y")
            check("ln_fwd", got[1], want[1], f"{str(dtype)[6:]} mean")
            check("ln_fwd", got[2], want[2], f"{str(dtype)[6:]} invvar")
            if dtype != torch.bfloat16:
                continue
            wl, bl = w.to(dtype), b.to(dtype)
            records.setdefault("ln_fwd", []).append(measure(
                "ln_fwd", f"rows={rows} hidden={hidden} bf16", err,
                lambda: ln.layer_norm_fwd(x, w, b, 1e-5, False),
                lambda: ln._ln_fwd_plain(x, w, b, 1e-5, False),
                ("F.layer_norm",
                 lambda: F.layer_norm(x, (hidden,), wl, bl, 1e-5)),
                nbytes=2 * x.numel() * x.element_size() + 2 * hidden * 4
                + 2 * rows * 4, ops=8.0 * x.numel(), dtype=dtype))

    # -- short prefill attention: b=1, h=8, causal ----------------------
    log("[kernels] short_fwd (CUDA), b=1 h=8 d=128 causal")
    for dtype in (torch.float32, torch.bfloat16):
        for s in (512, 100):
            q, k, v = (randn(1, heads, s, d, dtype=dtype) for _ in range(3))
            got = short.short_fwd(q, k, v, causal=True)
            want = short._short_fwd_plain(q, k, v, True, d ** -0.5)
            err = check("short_fwd", got[0], want[0],
                        f"{str(dtype)[6:]} s={s} out")
            lse_err = max_err(got[1], want[1])
            if not lse_err <= 1e-3:
                fail(f"short_fwd {dtype} s={s} lse: error {lse_err:.3g} "
                     "> 1e-3")
            log(f"  short_fwd {str(dtype)[6:]} s={s} lse: max_abs_err "
                f"{lse_err:.3g} (tolerance 1e-3)")
            if dtype != torch.bfloat16 or s != 512:
                continue
            pairs = heads * s * (s + 1) / 2           # causal (q, k) pairs
            records["short_fwd"] = [measure(
                "short_fwd", f"b=1 h={heads} s={s} d={d} causal bf16", err,
                lambda: short.short_fwd(q, k, v, causal=True),
                lambda: short._short_fwd_plain(q, k, v, True, d ** -0.5),
                ("SDPA", lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)),
                nbytes=4 * q.numel() * q.element_size() + heads * s * 4,
                ops=4.0 * d * pairs, dtype=dtype)]

    # -- paged decode: 4 slots, 9 pages of 64, ragged incl. idle --------
    log("[kernels] paged_decode (CUDA), 4 slots h=8 d=128 page 64 x 9")
    page, pps = 64, 9
    lengths = torch.tensor([0, 1, 300, 576], dtype=torch.int32)
    num_pages = 1 + int(sum(-(-int(n) // page) for n in lengths))
    perm = torch.randperm(num_pages - 1, generator=torch.Generator()
                          .manual_seed(1)) + 1
    table = torch.zeros((4, pps), dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths.tolist()):
        used = -(-n // page)
        table[i, :used] = perm[at:at + used]
        at += used
    table, lengths = table.to(dev), lengths.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        kp = randn(num_pages, heads, page, d, dtype=dtype)
        vp = randn(num_pages, heads, page, d, dtype=dtype)
        kp[0] = float("nan")        # garbage on the null page stays out
        vp[0] = float("nan")
        for sq in (1, 4):
            q = randn(4, heads, sq, d, dtype=dtype)
            got = dec.fmha_decode(q, kp, vp, table, lengths)
            want = dec.paged_attention_reference(q, kp, vp, table, lengths)
            err = check("paged_decode", got, want,
                        f"{str(dtype)[6:]} sq={sq} out")
            if not torch.isfinite(got).all():
                fail("paged_decode: non-finite output")
            if dtype != torch.bfloat16 or sq != 1:
                continue
            toks = int(lengths.sum())
            records["paged_decode"] = [measure(
                "paged_decode",
                "4 slots, lengths 0/1/300/576, h=8 d=128 page=64 bf16", err,
                lambda: dec.fmha_decode(q, kp, vp, table, lengths),
                lambda: dec.paged_attention_reference(
                    q, kp, vp, table, lengths),
                None,
                nbytes=2 * q.numel() * q.element_size()
                + 2 * toks * heads * d * kp.element_size()
                + table.numel() * 4 + lengths.numel() * 4,
                ops=4.0 * d * heads * toks, dtype=dtype)]
    return records


# ---------------------------------------------------------------- phase 3
def serve(model, requests, max_prompt_len, page_size, max_seqs,
          pages_per_seq, harvest_every=8):
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, init_pools)

    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + max_seqs * pages_per_seq,
        page_size=page_size, max_seqs=max_seqs,
        pages_per_seq=pages_per_seq, dtype=c.compute_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=max_prompt_len)
    prefill_s = []

    def timed_prefill(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fns.prefill(*args)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return out

    batcher = ContinuousBatcher(
        timed_prefill, fns.decode, PagedKVCache(ccfg),
        init_pools(ccfg, model.device), max_prompt_len=max_prompt_len,
        harvest_every=harvest_every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = batcher.run(requests)
    torch.cuda.synchronize()
    return comps, time.perf_counter() - t0, prefill_s, batcher


def phase_parity(dev) -> None:
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving import Request

    log("[parity] flagship width, 2 layers, fp32: paged greedy vs "
        "full recompute")
    cfg = GPTConfig(**dict(FLAGSHIP, num_layers=2),
                    compute_dtype=torch.float32)
    model = GPTModel(cfg, device=dev, seed=1)
    rng = np.random.RandomState(2)
    plens = np.array([48, 17, 64, 5, 33, 60])
    prompts = rng.randint(1, cfg.vocab_size, (6, 64)).astype(np.int32)
    for i, n in enumerate(plens):
        prompts[i, n:] = 0
    new = 16
    ref = model.generate_reference(prompts, plens, new)
    reqs = [Request(uid=i, prompt=prompts[i, :n].tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    comps, _, _, _ = serve(model, reqs, max_prompt_len=64, page_size=16,
                           max_seqs=2, pages_per_seq=5, harvest_every=4)
    for i in range(6):
        if comps[i].tokens != ref[i].tolist():
            fail(f"parity: request {i} paged {comps[i].tokens} != "
                 f"reference {ref[i].tolist()}")
    distinct = len({t for r in ref.tolist() for t in r})
    log(f"  6 requests x {new} tokens identical ({distinct} distinct ids)")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def phase_serve(dev) -> dict:
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[serve] flagship GPT, 12 layers, bf16: 8 requests x 32 tokens, "
        "4 slots, pages 64 x 9")
    cfg = GPTConfig(**FLAGSHIP, compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device=dev, seed=0)
    plens = np.linspace(32, 512, 8).astype(int)
    rng = np.random.RandomState(0)
    new = 32
    reqs = [Request(uid=i, prompt=rng.randint(1, cfg.vocab_size, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    # one untimed request first: allocator warm-up and lazy module loads
    serve(model, [Request(uid="warm", prompt=[1, 2, 3], max_new_tokens=2)],
          512, 64, 4, 9)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    comps, wall, prefill_s, batcher = serve(model, reqs, 512, 64, 4, 9)
    torch.cuda.synchronize()
    counts = launch_counts()
    for i in range(len(reqs)):
        toks = comps[i].tokens
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            fail(f"serve: request {i} returned {toks}")
    decode_s = wall - sum(prefill_s)
    decode_tokens = len(reqs) * (new - 1)
    ttft = sorted(c.ttft_s for c in comps.values())
    log(f"  {len(reqs)} requests complete, {batcher.steps} decode steps "
        f"in {batcher.windows} harvest windows, wall {wall:.3f} s")
    log(f"  prefill: {int(plens.sum())} prompt tokens (padded to 512 per "
        f"request) in {sum(prefill_s):.3f} s = "
        f"{plens.sum() / sum(prefill_s):.1f} prompt tokens/s, "
        f"{1e3 * np.mean(prefill_s):.2f} ms per prefill")
    log(f"  decode: {decode_tokens} tokens in {decode_s:.3f} s = "
        f"{decode_tokens / decode_s:.1f} tokens/s, "
        f"{1e3 * decode_s / batcher.steps:.2f} ms per step (4 slots)")
    log(f"  TTFT p50 {1e3 * ttft[len(ttft) // 2]:.1f} ms, max "
        f"{1e3 * ttft[-1]:.1f} ms (quantized to the harvest window)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    log(f"  launches in this phase: {counts}")
    for name in ("ln_fwd", "short_fwd", "paged_decode"):
        if counts.get(name, 0) <= 0:
            fail(f"serve: kernel {name} never launched on the main path")
    # the bf16 path against the same weights at fp32 compute
    ref = GPTModel(dataclasses.replace(cfg, compute_dtype=torch.float32),
                   device=dev)
    ref.load_state_dict(model.state_dict())
    toks = torch.as_tensor([reqs[3].prompt], device=dev)
    with torch.no_grad():
        lo = model.apply(toks)[0].float()
        hi = ref.apply(toks)[0]
    band = (lo - hi).abs().max().item()
    agree = (lo.argmax(-1) == hi.argmax(-1)).float().mean().item()
    log(f"  bf16 vs fp32 logits over a {toks.shape[1]}-token prompt: max "
        f"|diff| {band:.4f} (logit scale {hi.abs().max().item():.3f}), "
        f"argmax agrees at {100 * agree:.1f}% of positions")
    del ref
    return counts, model


def device_breakdown(prof, wall_s: float, label: str) -> None:
    """Device busy share and the kernels that took the device's time,
    from a ``torch.profiler`` run of ``wall_s`` seconds."""
    from apex_tpu_torch.telemetry import PHASE_PREFIX

    rows = []
    for e in prof.key_averages():
        # kernels and device copies only: an aten op's own entry repeats
        # the device time of the kernels it launched
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith(PHASE_PREFIX)):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t, e.count, e.key))
    busy_us = sum(r[0] for r in rows)
    if busy_us == 0:
        log(f"  {label}: device time not measured (the profiler saw none)")
        return
    log(f"  {label}: wall {1e3 * wall_s:.2f} ms under the profiler, "
        f"device busy {busy_us / 1e3:.2f} ms = "
        f"{100 * busy_us / (1e6 * wall_s):.1f}% (idle "
        f"{100 - 100 * busy_us / (1e6 * wall_s):.1f}%)")
    for t, n, key in sorted(rows, reverse=True)[:8]:
        log(f"    {100 * t / busy_us:5.1f}% {t / 1e3:8.3f} ms {n:6d} calls "
            f"{key[:90]}")


# ---------------------------------------------------------------- phase 5
def phase_profile(model) -> None:
    """Where the serving time goes: 4 prefills of 256-token prompts, then
    one harvest window of 8 decode steps over 4 slots, each under
    ``torch.profiler``."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, Request,
        init_pools)

    log("[profile] flagship GPT, bf16: 4 prefills (256 tokens), then 8 "
        "decode steps x 4 slots")
    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=37, page_size=64, max_seqs=4,
        pages_per_seq=9, dtype=c.compute_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=512)
    batcher = ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg),
        init_pools(ccfg, model.device), max_prompt_len=512, harvest_every=8)
    rng = np.random.RandomState(1)
    queue = collections.deque(
        Request(uid=i, prompt=rng.randint(1, c.vocab_size, 256).tolist(),
                max_new_tokens=17) for i in range(4))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, step in (("prefill x4", lambda: batcher._admit(queue)),
                        ("decode x8", batcher._decode_window)):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_breakdown(prof, wall, label)


SOURCES = {
    "ln_fwd": ("triton", "apex_tpu_torch/ops/layer_norm.py",
               "apex_tpu/ops/layer_norm.py:66"),
    "short_fwd": ("cuda", "apex_tpu_torch/csrc/attention_short.cu",
                  "apex_tpu/ops/attention_short.py:149"),
    "paged_decode": ("cuda", "apex_tpu_torch/csrc/attention_decode.cu",
                     "apex_tpu/ops/attention_decode.py:210"),
}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs on the GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    card = phase_build()
    records = phase_kernels(dev)
    phase_parity(dev)
    counts, model = phase_serve(dev)
    phase_profile(model)
    # one record per kernel, at the shape the serving path calls most:
    # layer norm at the decode step's 4 rows, attention at a 512-token
    # prefill, decode at one step over the ragged cache
    kernels = [dict(name=name, route=route, source=source,
                    replaces=replaces, launches=counts.get(name, 0),
                    **records[name][0])
               for name, (route, source, replaces) in SOURCES.items()]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
