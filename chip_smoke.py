"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit, and no result line):

1. build   — compile the CUDA kernels under ``apex_tpu_torch/csrc``
             (one ``nvcc`` per source, all at once) and print the card's
             name and power limit as ``nvidia-smi`` reports them.
2. kernels — hold each hand-written kernel against its plain PyTorch
             version on the card, at the serving and training paths'
             shapes, in bf16 and fp32; print each one's error, time,
             bound and the time of a PyTorch library call for the same
             function, if any; a short-vs-mid reading at s in {256, 384,
             512}, the flash kernels at b=2 h=8 s=4096 (and a reading at
             s=8192), the decode kernel's fused q-RoPE, and a mid-vs-flash
             reading at s in {1024, 2048, 4096}; the dequant-matmul
             kernels (int8 and int4 weights, block 128) at the decode
             shape (m=4) of each flagship projection, fc1 at m=512 and
             qkv and fc2 at m=2304 (with one k split and with several,
             in both kernels), beside torch.matmul on the dense bf16
             weight; the decode kernel over int8 pages at
             877 and 4 x 2300 cached tokens, beside bf16 pages.
3. parity  — the flagship GPT's width at 2 layers, fp32 compute: the
             paged greedy tokens of ``ContinuousBatcher`` (6 ragged
             requests, 2 slots, 16 new tokens) must equal the port's
             full-recompute ``generate_reference`` token for token, and
             so must a 600-token prompt's (prefill on the mid rung); then
             the same for the Llama-mode GPT (rope, RMSNorm, SwiGLU) with
             prompts up to 2500 tokens (prefill on the flash rung, decode
             through the fused q-RoPE).
   quant-parity — the same 2-layer fp32 flagship served from int8 and
             int4 weight pools, and the Llama mode from int4: paged
             greedy == ``generate_reference`` on the same pools, both
             through the dequant kernels; then int8 KV pages (fp32
             weights): every request completes, and their decode logits
             must stay within 2% of the logit scale of full-precision
             pages, with argmax agreeing at 98% of positions or more.
4. serve   — the full flagship GPT (12 layers, bf16): 8 requests with
             prompts of 32..512 tokens, 32 greedy tokens each, through
             ``decode_fns`` + ``ContinuousBatcher``, then one 900-token
             prompt (prefill padded to 960); every request must complete,
             and every serving kernel must have launched in this phase;
             the bf16 logits are printed beside the same weights at fp32.
5. profile — the same model under ``torch.profiler``: four prefills,
             then one harvest window of decode steps; the device's busy
             share and the kernels that took its time.
   serve-quant — the same model and requests served from weights
             {bf16 copies made once, int8, int4} x KV pages {bf16, int8}:
             decode ms/step, ms per prefill, the weight bytes a step
             streams and the rate that implies, the KV pool's bytes, and
             the int8/int4 logits against bf16 weights; every request
             must complete and the three new kernels must launch; a
             decode window profiled with the bf16 copies and at int4
             weights with int8 KV.
   serve-long — the 12-layer Llama-mode GPT in bf16: four requests of
             64..2300 prompt tokens (prefill padded to 2304, the flash
             rung), 32 greedy tokens each, decode with the fused q-RoPE;
             then phase 5's profile of it (prompts of 2300 tokens), and
             the same four requests from int8 weights and int8 KV pages
             (the dequant kernels at m=2304 in prefill).
6. train-parity — one step of loss, backward and FusedAdam on the GPU
             (kernels) against a CPU copy of the same model and state
             (plain versions), fp32, 2 layers at the flagship's width:
             the flagship at s=384 (short rung) and s=640 (mid rung), the
             Llama mode at s=2560 (flash rung): loss, every grad and the
             updated parameters must agree.
7. train   — the full flagship at O5, 8 x 1024 tokens, remat on, through
             the port trainer's step: 2 warm-up and 10 timed steps; the
             loss must be finite and fall, and the mid kernels must have
             launched.  Prints ms/step, tokens/s, MFU, peak memory, the
             launches and the step-1 loss at O5 against fp32.
8. profile — one training step under ``torch.profiler``.
9. train-long — the 12-layer Llama-mode GPT at O5, 2 x 4096 tokens, as
             ``gpt_pretrain --position-embedding rope --activation swiglu
             --normalization rmsnorm --seq 4096 --micro-batch 2
             --num-micro 1`` trains it, the same measurements as phase 7,
             the flash kernels required; then one step profiled.

The last two lines are a JSON object with one record per kernel, and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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
# the Llama-mode GPT at the same widths (the JAX trainer's defaults with
# --position-embedding rope --activation swiglu --normalization rmsnorm):
# no position table, three SwiGLU matrices of 4096
LLAMA = dict(vocab_size=32768, num_layers=12, hidden_size=1024,
             num_attention_heads=8, ffn_hidden_size=4096,
             position_embedding="rope", activation="swiglu",
             normalization="rmsnorm")
LONG_SEQ = 4096         # its training length, past the mid rung's 2048


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
            dtype, plain_iters: int = 50) -> dict:
    """Time a kernel, its plain version (over ``plain_iters`` calls) and
    (``(label, fn)`` or None) the PyTorch call that computes the same
    function; the bound is the larger of ``nbytes`` over the memory rate
    and ``ops`` over the peak rate of ``dtype``."""
    ms, eager = time_ms(kernel)
    plain_ms, _ = time_ms(plain, plain_iters)
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
    # the -Xptxas -v report, summed per source: a kernel that spills or
    # needs more registers than its launch bounds allow shows here
    for name, text in sorted(logs.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in
                     re.findall(r"(\d+) bytes spill stores", text))
        log(f"  {name}: {len(regs)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers a thread, {spills} bytes "
            "of spill stores")
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

    records.update(attention_train_kernels(randn))

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

    # -- the fused q-RoPE: the rope table's rows at each query position,
    #    as the Llama-mode decode step hands them to the kernel
    log("[kernels] paged_decode with the fused q-RoPE, same layout")
    from apex_tpu_torch.ops.rope import rope_table

    cos_t, sin_t = rope_table(pps * page, d, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        kp = randn(num_pages, heads, page, d, dtype=dtype)
        vp = randn(num_pages, heads, page, d, dtype=dtype)
        for sq in (1, 4):
            q = randn(4, heads, sq, d, dtype=dtype)
            pos = (lengths[:, None].long() - sq
                   + torch.arange(sq, device=dev)).clamp_min(0)
            rope = (cos_t[pos], sin_t[pos])
            got = dec.fmha_decode(q, kp, vp, table, lengths, rope=rope)
            want = dec._decode_plain(q, kp, vp, table, lengths, True,
                                     d ** -0.5, rope)
            check("paged_decode", got, want,
                  f"{str(dtype)[6:]} sq={sq} with rope out")
            if dtype == torch.bfloat16 and sq == 1:
                with_rope, _ = time_ms(lambda: dec.fmha_decode(
                    q, kp, vp, table, lengths, rope=rope))
                without, _ = time_ms(lambda: dec.fmha_decode(
                    q, kp, vp, table, lengths))
                log(f"  paged_decode bf16 sq=1: {with_rope:.4f} ms with the "
                    f"fused q-RoPE, {without:.4f} ms without")
    records.update(flash_kernels(randn))
    crossover_long(randn)
    records.update(dequant_kernels(randn))
    records.update(decode_int8_kernels(randn, dev))
    return records


#: the flagship's projections (k, n) at the decode shape (m = 4 slots),
#: fc1 at a 512-token prefill, and qkv and fc2 at serve-quant-long's
#: 2304-token prefill
DEQUANT_SHAPES = (("qkv", 4, 1024, 3072), ("attn_proj", 4, 1024, 1024),
                  ("fc1", 4, 1024, 4096), ("fc2", 4, 4096, 1024),
                  ("fc1", 512, 1024, 4096), ("qkv", 2304, 1024, 3072),
                  ("fc2", 2304, 4096, 1024))


def dequant_kernels(randn) -> dict:
    """``dequant_int8`` and ``dequant_int4`` against their plain versions,
    block 128, bf16 and fp32 x, at :data:`DEQUANT_SHAPES`.  The bound is
    the bytes moved (x, the quantized weights and scales, the output) or
    the fp32 arithmetic (2mkn plus one dequantizing multiply per weight at
    67 TFLOP/s); no PyTorch call takes block-scaled int8/int4 weights, so
    there is no library time.  A separate reading: ``torch.matmul`` on the
    dense bf16 weight at each shape, the time the quantized pool has to
    beat.

    Each kernel (decode, m <= 8; tiled, above) stores straight to the
    output when k is not split and through the fixed-order sum when it
    is; the shapes must reach all four, or the phase fails.  No flagship
    projection leaves the decode kernel one split, so a probe as wide as
    two column tiles an SM (k = 256) reaches its direct store."""
    from apex_tpu_torch.ops.dequant_matmul import (
        SKINNY_MAX_M, dequant_matmul, dequant_matmul_reference,
        quantize_weight, split_plan)

    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    shapes = DEQUANT_SHAPES + (("direct-store probe", 4, 256, 512 * sms),)
    splits = {shape: split_plan(*shape[1:], sms)[1] for shape in shapes}
    reached = {(m <= SKINNY_MAX_M, splits[(name, m, k, n)] == 1)
               for name, m, k, n in shapes}
    if len(reached) != 4:
        fail(f"dequant: the shapes reach only (decode kernel, one split) "
             f"= {sorted(reached)} of the four store paths")
    records = {}
    log("[kernels] dequant_int8, dequant_int4 (CUDA), block 128")
    for name, m, k, n in shapes:
        w = randn(k, n, scale=0.02)
        for wd in ("int8", "int4"):
            kernel = f"dequant_{wd}"
            pool = quantize_weight(w, wd, 128)
            q, s = pool["q8" if wd == "int8" else "q4"], pool["scales"]
            for dtype in (torch.bfloat16, torch.float32):
                x = randn(m, k, dtype=dtype)
                shape = (f"{name} m={m} k={k} n={n} "
                         f"({splits[(name, m, k, n)]} k splits) x "
                         f"{str(dtype)[6:]}")
                run = lambda: dequant_matmul(x, q, s, weight_dtype=wd)
                plain = lambda: dequant_matmul_reference(
                    x, q, s, weight_dtype=wd, block_size=128)
                err = check(kernel, run(), plain(), shape)
                records.setdefault(kernel, []).append(measure(
                    kernel, shape, err, run, plain, None,
                    nbytes=x.numel() * x.element_size() + q.numel()
                    + s.numel() * 4 + m * n * x.element_size(),
                    ops=2.0 * m * k * n + k * n, dtype=torch.float32))
        xb, wb = randn(m, k, dtype=torch.bfloat16), w.to(torch.bfloat16)
        ms, _ = time_ms(lambda: torch.matmul(xb, wb))
        log(f"  dense bf16 torch.matmul {name} m={m} k={k} n={n}: "
            f"{ms:.4f} ms on the device")
    return records


def paged_layout(lengths, page: int, pps: int, dev):
    """A page table for ``lengths`` cached tokens a slot, its pages
    scattered through the pool (page 0, the null page, unused): returns
    ``(table, lengths, num_pages)`` on ``dev``."""
    num_pages = 1 + sum(-(-n // page) for n in lengths)
    perm = torch.randperm(num_pages - 1, generator=torch.Generator()
                          .manual_seed(1)) + 1
    table = torch.zeros((len(lengths), pps), dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths):
        used = -(-n // page)
        table[i, :used] = perm[at:at + used]
        at += used
    return (table.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                        device=dev), num_pages)


def decode_int8_kernels(randn, dev) -> dict:
    """``paged_decode_int8`` against its plain version (bf16 and fp32 q,
    sq 1 and 4) over pages the cache's quantizer made from random rows, at
    phase 2's 4-slot layout (877 cached tokens) and at serve-long's 2300
    tokens a slot; timed at bf16 q, sq=1, beside the bf16 pages' kernel
    over the same values dequantized."""
    from apex_tpu_torch.ops import attention_decode as dec
    from apex_tpu_torch.ops.quantization import quantize_rows

    heads, d, page = FLAGSHIP["num_attention_heads"], 128, 64
    records = {}
    log(f"[kernels] paged_decode_int8 (CUDA), 4 slots h={heads} d={d} page "
        f"{page}, kv_block 128")
    for lengths, pps in (([0, 1, 300, 576], 9), ([2300] * 4, 37)):
        table, lens, num_pages = paged_layout(lengths, page, pps, dev)
        pages = []
        for _ in range(2):
            vals, sc = quantize_rows(
                randn(num_pages * heads * page, d), 128)
            pages.append((vals.view(num_pages, heads, page, d),
                          sc.view(num_pages, heads, page, 1)))
        (kp, ks), (vp, vs) = pages
        toks = sum(lengths)
        for dtype in (torch.bfloat16, torch.float32):
            for sq in (1, 4):
                q = randn(4, heads, sq, d, dtype=dtype)
                run = lambda: dec.fmha_decode(q, kp, vp, table, lens,
                                              k_scales=ks, v_scales=vs)
                plain = lambda: dec.paged_attention_reference(
                    q, kp, vp, table, lens, k_scales=ks, v_scales=vs)
                what = f"{str(dtype)[6:]} sq={sq} {toks} cached tokens"
                err = check("paged_decode_int8", run(), plain(), what)
                if dtype != torch.bfloat16 or sq != 1:
                    continue
                records.setdefault("paged_decode_int8", []).append(measure(
                    "paged_decode_int8",
                    f"4 slots, lengths {'/'.join(map(str, lengths))}, "
                    f"h={heads} d={d} page={page} int8 pages, bf16 q", err,
                    run, plain,
                    None,
                    nbytes=2 * q.numel() * q.element_size()
                    + 2 * toks * heads * (d + 4) + table.numel() * 4
                    + lens.numel() * 4,
                    ops=4.0 * d * heads * toks, dtype=dtype))
                kb, vb = ((p.float() * sc).to(dtype) for p, sc in pages)
                bf16_ms, _ = time_ms(lambda: dec.fmha_decode(
                    q, kb, vb, table, lens))
                log(f"  paged_decode over bf16 pages, same layout: "
                    f"{bf16_ms:.4f} ms on the device")
    return records


def flash_kernels(randn) -> dict:
    """The flash rung's kernels against their plain versions on the
    flattened ``(b*h, s, d)`` layout: at the long-context training shape
    (b=2 h=8 s=4096 d=128 causal) and on ragged lengths (2500 causal, 700
    queries x 900 keys full), fp32 and bf16.  The backward kernels get
    the plain forward's ``lse`` and ``delta``, so each is held alone.
    Times at bf16 and s=4096; library calls SDPA forward, and SDPA
    forward+backward through autograd for both backward kernels.  Then a
    reading at the JAX bench's probe shape, b=2 h=8 s=8192."""
    from apex_tpu_torch.ops import attention_flash as fl
    import torch.nn.functional as F

    b, heads, d = 2, LLAMA["num_attention_heads"], 128
    scale = d ** -0.5
    records = {}
    log("[kernels] flash_fwd, flash_bwd_dkv, flash_bwd_dq (CUDA), d=128")
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for bh, sq, sk, causal in ((b * heads, LONG_SEQ, LONG_SEQ, True),
                                   (4, 2500, 2500, True),
                                   (4, 700, 900, False)):
            q, dout = (randn(bh, sq, d, dtype=dtype) for _ in range(2))
            k, v = (randn(bh, sk, d, dtype=dtype) for _ in range(2))
            what = f"{dt} bh={bh} sq={sq} sk={sk} causal={causal}"
            got = fl.flash_fwd(q, k, v, causal=causal)
            out, lse = fl._flash_fwd_plain(q, k, v, causal, scale)
            fwd_err = check("flash_fwd", got[0], out, f"{what} out")
            lse_err = max_err(got[1], lse)
            if not lse_err <= 1e-3:
                fail(f"flash_fwd {what} lse: error {lse_err:.3g} > 1e-3")
            delta = fl.flash_delta(out, dout)
            want = fl._flash_bwd_plain(q, k, v, dout, lse, delta, causal,
                                       scale)
            dk, dv = fl.flash_bwd_dkv(q, k, v, dout, lse, delta,
                                      causal=causal)
            dq = fl.flash_bwd_dq(q, k, v, dout, lse, delta, causal=causal)
            dq_err = check("flash_bwd_dq", dq, want[0], f"{what} dq")
            dkv_err = max(check("flash_bwd_dkv", dk, want[1], f"{what} dk"),
                          check("flash_bwd_dkv", dv, want[2], f"{what} dv"))
            if dtype != torch.bfloat16 or sq != LONG_SEQ:
                continue
            s = LONG_SEQ
            shape = f"b={b} h={heads} s={s} d={d} causal bf16"
            numel = q.numel() * q.element_size()
            rows = b * heads * s * 4                  # an fp32 (b*h, s) row
            pairs = b * heads * s * (s + 1) / 2       # causal (q, k) pairs
            q4, k4, v4, do4 = (t.view(b, heads, s, d)
                               for t in (q, k, v, dout))
            qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
                torch.autograd.grad(o, (qg, kg, vg), do4)

            fb_ms = profiled_ms(sdpa_fwd_bwd)
            log(f"  SDPA forward+backward through autograd {shape}: "
                f"{fb_ms:.4f} ms of device time (profiler)")
            records["flash_fwd"] = [measure(
                "flash_fwd", shape, fwd_err,
                lambda: fl.flash_fwd(q, k, v, causal=True),
                lambda: fl._flash_fwd_plain(q, k, v, True, scale),
                ("SDPA", lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True)),
                nbytes=4 * numel + rows, ops=4.0 * d * pairs, dtype=dtype,
                plain_iters=10)]
            plain_bwd = lambda: fl._flash_bwd_plain(q, k, v, dout, lse, delta,
                                                    True, scale)
            # dK/dV: four products per (q, k) pair (s, dp, dv, dk); dQ:
            # three (s, dp, dq); each reads q, k, v, dout, lse and delta
            for name, fn, n_out, n_prod, err in (
                    ("flash_bwd_dkv", lambda: fl.flash_bwd_dkv(
                        q, k, v, dout, lse, delta, causal=True), 2, 4,
                     dkv_err),
                    ("flash_bwd_dq", lambda: fl.flash_bwd_dq(
                        q, k, v, dout, lse, delta, causal=True), 1, 3,
                     dq_err)):
                rec = measure(name, shape, err, fn, plain_bwd, None,
                              nbytes=(4 + n_out) * numel + 2 * rows,
                              ops=2.0 * n_prod * d * pairs, dtype=dtype,
                              plain_iters=10)
                rec["library_ms"] = fb_ms
                log(f"  {name}: library call is SDPA forward+backward "
                    f"({fb_ms:.4f} ms), which includes a forward and the "
                    "other backward kernel's work")
                records[name] = [rec]

    # one reading at the JAX bench's probe shape
    s = 2 * LONG_SEQ
    q, k, v, dout = (randn(b * heads, s, d, dtype=torch.bfloat16)
                     for _ in range(4))
    out, lse = fl.flash_fwd(q, k, v, causal=True)
    delta = fl.flash_delta(out, dout)
    if not torch.isfinite(out).all():
        fail(f"flash_fwd s={s}: non-finite output")
    pairs = b * heads * s * (s + 1) / 2
    reading = []
    for name, fn, ops in (
            ("flash_fwd", lambda: fl.flash_fwd(q, k, v, causal=True), 4),
            ("flash_bwd_dkv", lambda: fl.flash_bwd_dkv(
                q, k, v, dout, lse, delta, causal=True), 8),
            ("flash_bwd_dq", lambda: fl.flash_bwd_dq(
                q, k, v, dout, lse, delta, causal=True), 6),
            ("SDPA forward", lambda: F.scaled_dot_product_attention(
                q.view(b, heads, s, d), k.view(b, heads, s, d),
                v.view(b, heads, s, d), is_causal=True), 4)):
        ms, _ = time_ms(fn, 10)
        bnd, _ = bound_ms(0, ops * d * pairs, torch.bfloat16)
        reading.append(f"{name} {ms:.4f} ms (bound {bnd:.4f})")
    log(f"  b={b} h={heads} s={s} d={d} causal bf16: " + ", ".join(reading))
    return records


def crossover_long(randn) -> None:
    """A mid-vs-flash reading at s in {1024, 2048, 4096} with 8192 tokens
    (b = 8192 / s, h=8, d=128, causal, bf16): device ms of each rung's
    forward and backward (the flash backward is delta, dK/dV and dQ, as
    its autograd function runs them).  Recorded only; the ladder keeps
    the JAX package's 2048."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid

    heads, d = 8, 128
    log("[kernels] mid vs flash crossover, 8192 tokens, h=8 d=128 causal "
        "bf16")
    for s in (1024, 2048, LONG_SEQ):
        b = 8192 // s
        q, k, v, dout = (randn(b, heads, s, d, dtype=torch.bfloat16)
                         for _ in range(4))
        flat = [t.view(b * heads, s, d) for t in (q, k, v, dout)]
        out, lse = mid.mid_fwd(q, k, v, causal=True)
        fout, flse = fl.flash_fwd(*flat[:3], causal=True)

        def flash_bwd():
            delta = fl.flash_delta(fout, flat[3])
            fl.flash_bwd_dkv(*flat, flse, delta, causal=True)
            fl.flash_bwd_dq(*flat, flse, delta, causal=True)

        row = []
        for name, fwd, bwd in (
                ("mid", lambda: mid.mid_fwd(q, k, v, causal=True),
                 lambda: mid.mid_bwd(q, k, v, out, dout, lse, causal=True)),
                ("flash", lambda: fl.flash_fwd(*flat[:3], causal=True),
                 flash_bwd)):
            f_ms, _ = time_ms(fwd, 20)
            b_ms, _ = time_ms(bwd, 20)
            row.append(f"{name} fwd {f_ms:.4f} ms bwd {b_ms:.4f} ms")
        log(f"  s={s} b={b}: " + "; ".join(row))


def profiled_ms(fn, iters: int = 10) -> float:
    """Device ms per call of ``fn``: the kernels' device time summed by
    ``torch.profiler`` over ``iters`` calls after a warm-up.  For library
    calls through autograd, which are not captured in a CUDA graph here
    and whose eager calls the host's launch rate can outlast."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(r[0] for r in device_rows(prof))
    if busy_us == 0:
        fail("profiled_ms: the profiler saw no device time")
    return busy_us / 1e3 / iters


def attention_train_kernels(randn) -> dict:
    """The training path's attention kernels against their plain versions,
    causal, b=8 h=8 d=128, fp32 and bf16: ``short_bwd`` at s=512,
    ``mid_fwd``/``mid_bwd`` at the flagship's training length s=1024 and a
    ragged s=640 (the latter with a real lse cotangent).  The backward
    kernels get the plain forward's ``out``/``lse``, so each is held alone.
    Times at bf16 for s=512 (short) and s=1024 (mid); the library calls
    are SDPA forward and SDPA forward+backward through autograd."""
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short
    import torch.nn.functional as F

    b, heads, d = 8, FLAGSHIP["num_attention_heads"], 128
    scale = d ** -0.5
    records = {}
    log("[kernels] short_bwd, mid_fwd, mid_bwd (CUDA), b=8 h=8 d=128 causal")
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for kind, s in (("short", 512), ("mid", 1024), ("mid", 640)):
            q, k, v, dout = (randn(b, heads, s, d, dtype=dtype)
                             for _ in range(4))
            numel = q.numel() * q.element_size()
            pairs = b * heads * s * (s + 1) / 2      # causal (q, k) pairs
            fwd_err = None
            if kind == "mid":
                got = mid.mid_fwd(q, k, v, causal=True)
                want = mid._mid_fwd_plain(q, k, v, True, scale)
                fwd_err = check("mid_fwd", got[0], want[0],
                                f"{dt} s={s} out")
                lse_err = max_err(got[1], want[1])
                if not lse_err <= 1e-3:
                    fail(f"mid_fwd {dt} s={s} lse: error {lse_err:.3g} "
                         "> 1e-3")
                log(f"  mid_fwd {dt} s={s} lse: max_abs_err {lse_err:.3g} "
                    "(tolerance 1e-3)")
            out, lse = short._short_fwd_plain(q, k, v, True, scale)
            dlse = randn(b, heads, s) if s == 640 else None
            name = f"{kind}_bwd"
            bwd, plain = ((short.short_bwd, short._short_bwd_plain)
                          if kind == "short"
                          else (mid.mid_bwd, mid._mid_bwd_plain))
            got = bwd(q, k, v, out, dout, lse, dlse, causal=True)
            want = plain(q, k, v, out, dout, lse, dlse, True, scale)
            what = f"{dt} s={s}" + (" with dlse" if dlse is not None else "")
            errs = [check(name, g, w, f"{what} {n}")
                    for g, w, n in zip(got, want, ("dq", "dk", "dv"))]
            if dtype != torch.bfloat16 or s == 640:
                continue
            shape = f"b={b} h={heads} s={s} d={d} causal bf16"
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
                torch.autograd.grad(o, (qg, kg, vg), dout)

            fb_ms = profiled_ms(sdpa_fwd_bwd)
            log(f"  SDPA forward+backward through autograd {shape}: "
                f"{fb_ms:.4f} ms of device time (profiler)")
            if kind == "mid":
                records["mid_fwd"] = [measure(
                    "mid_fwd", shape, fwd_err,
                    lambda: mid.mid_fwd(q, k, v, causal=True),
                    lambda: mid._mid_fwd_plain(q, k, v, True, scale),
                    ("SDPA", lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True)),
                    nbytes=4 * numel + b * heads * s * 4, ops=4.0 * d * pairs,
                    dtype=dtype)]
            # five products per (q, k) pair: s, dp, dv, dk, dq
            rec = measure(
                name, shape, max(errs),
                lambda: bwd(q, k, v, out, dout, lse, causal=True),
                lambda: plain(q, k, v, out, dout, lse, None, True, scale),
                None, nbytes=8 * numel + b * heads * s * 4,
                ops=10.0 * d * pairs, dtype=dtype)
            rec["library_ms"] = fb_ms
            log(f"  {name}: library call is SDPA forward+backward "
                f"({fb_ms:.4f} ms), which includes a forward")
            records[name] = [rec]
    crossover(randn)
    return records


def crossover(randn) -> None:
    """A first short-vs-mid reading at s in {256, 384, 512} (b=8 h=8
    d=128 causal bf16): device ms of forward and backward on each rung.
    Recorded only; the ladder's boundary stays the JAX package's 512."""
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    b, heads, d = 8, FLAGSHIP["num_attention_heads"], 128
    log("[kernels] short vs mid crossover, b=8 h=8 d=128 causal bf16")
    for s in (256, 384, 512):
        q, k, v, dout = (randn(b, heads, s, d, dtype=torch.bfloat16)
                         for _ in range(4))
        out, lse = short.short_fwd(q, k, v, causal=True)
        row = []
        for name, fwd, bwd in (("short", short.short_fwd, short.short_bwd),
                               ("mid", mid.mid_fwd, mid.mid_bwd)):
            f_ms, _ = time_ms(lambda: fwd(q, k, v, causal=True))
            b_ms, _ = time_ms(lambda: bwd(q, k, v, out, dout, lse,
                                          causal=True))
            row.append(f"{name} fwd {f_ms:.4f} ms bwd {b_ms:.4f} ms")
        log(f"  s={s}: " + "; ".join(row))


# ---------------------------------------------------------------- phase 3
def serve(model, requests, max_prompt_len, page_size, max_seqs,
          pages_per_seq, harvest_every=8, weight_dtype=None, kv_dtype=None):
    """Serve ``requests`` through ``decode_fns`` (``weight_dtype``) over a
    fresh paged cache (``kv_dtype``) and ``ContinuousBatcher``.  Returns
    ``(completions, wall s, [prefill s], batcher)``."""
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, init_pools)

    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + max_seqs * pages_per_seq,
        page_size=page_size, max_seqs=max_seqs,
        pages_per_seq=pages_per_seq, dtype=c.compute_dtype,
        kv_dtype=kv_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=max_prompt_len,
                           weight_dtype=weight_dtype)
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
    # one prompt past the short rung: monolithic prefill through mid_fwd
    long_prompt = rng.randint(1, cfg.vocab_size, (1, 600)).astype(np.int32)
    ref = model.generate_reference(long_prompt, [600], new)
    comps, _, _, _ = serve(
        model, [Request(uid="long", prompt=long_prompt[0].tolist(),
                        max_new_tokens=new)],
        max_prompt_len=640, page_size=16, max_seqs=1, pages_per_seq=41)
    if comps["long"].tokens != ref[0].tolist():
        fail(f"parity: 600-token prompt paged {comps['long'].tokens} != "
             f"reference {ref[0].tolist()}")
    log(f"  a 600-token prompt (prefill padded to 640, mid rung): {new} "
        "tokens identical")
    del model
    torch.cuda.empty_cache()


def phase_rope_parity(dev) -> dict:
    """The Llama-mode GPT at the flagship's width, 2 layers, fp32: four
    requests of 2500, 300, 1200 and 50 tokens through 2 slots (prefill
    padded to 2560, the flash rung; decode through the fused q-RoPE) must
    give ``generate_reference``'s tokens.  Returns the launches."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[rope-parity] Llama-mode width, 2 layers, fp32: paged greedy vs "
        "full recompute, prompts up to 2500 tokens")
    cfg = GPTConfig(**dict(LLAMA, num_layers=2), compute_dtype=torch.float32)
    model = GPTModel(cfg, device=dev, seed=4)
    rng = np.random.RandomState(5)
    plens = np.array([2500, 300, 1200, 50])
    prompts = rng.randint(1, cfg.vocab_size, (4, 2500)).astype(np.int32)
    for i, n in enumerate(plens):
        prompts[i, n:] = 0
    new = 16
    ref = model.generate_reference(prompts, plens, new)
    reqs = [Request(uid=i, prompt=prompts[i, :n].tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    torch.cuda.synchronize()
    reset_launch_counts()
    comps, _, _, _ = serve(model, reqs, max_prompt_len=2560, page_size=64,
                           max_seqs=2, pages_per_seq=41, harvest_every=4)
    torch.cuda.synchronize()
    counts = launch_counts()
    for i in range(4):
        if comps[i].tokens != ref[i].tolist():
            fail(f"rope-parity: request {i} ({plens[i]} tokens) paged "
                 f"{comps[i].tokens} != reference {ref[i].tolist()}")
    distinct = len({t for r in ref.tolist() for t in r})
    log(f"  4 requests x {new} tokens identical ({distinct} distinct ids); "
        f"launches {counts}")
    for name in ("flash_fwd", "paged_decode"):
        if counts.get(name, 0) <= 0:
            fail(f"rope-parity: kernel {name} never launched")
    del model
    torch.cuda.empty_cache()
    return counts


def kv_logit_band(model, prompts, plens, steps: int, page_size: int = 16):
    """Decode logits from int8 KV pages against the same model's
    full-precision pages: both caches take the same prompts, then the
    same tokens (the full-precision path's greedy picks) for ``steps``
    decode steps.  Returns ``(max |diff|, share of positions whose argmax
    agrees, largest |logit|)``."""
    from apex_tpu_torch.serving import KVCacheConfig, PagedKVCache, init_pools

    c, dev = model.config, model.device
    S, width = prompts.shape
    pps = -(-(width + steps) // page_size)
    runs = []
    for kv_dtype in (None, torch.int8):
        ccfg = KVCacheConfig(
            num_layers=c.num_layers, num_heads=c.num_attention_heads,
            head_dim=c.head_dim, num_pages=1 + S * pps, page_size=page_size,
            max_seqs=S, pages_per_seq=pps, dtype=c.compute_dtype,
            kv_dtype=kv_dtype)
        cache, pools = PagedKVCache(ccfg), init_pools(ccfg, dev)
        fns = model.decode_fns(ccfg, max_prompt_len=width)
        firsts = []
        for i in range(S):
            cache.admit(i, int(plens[i]) + steps)
            pools, first = fns.prefill(
                pools, torch.as_tensor(prompts[i:i + 1], device=dev),
                int(plens[i]), torch.as_tensor(cache.page_table[i],
                                               device=dev))
            firsts.append(first)
        table = torch.as_tensor(cache.page_table, device=dev)
        runs.append((ccfg, table, pools, torch.stack(firsts)))
    tokens = runs[0][3].to(torch.int32)
    positions = torch.as_tensor(np.asarray(plens), dtype=torch.int32,
                                device=dev)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    band, scale, agree = 0.0, 0.0, []
    with torch.no_grad():
        for _ in range(steps):
            hi, lo = (model.decode_step(
                tokens, positions, active, table, pools,
                quantized=ccfg.quantized, kv_block=ccfg.kv_block)[0].float()
                for ccfg, table, pools, _ in runs)
            band = max(band, (lo - hi).abs().max().item())
            scale = max(scale, hi.abs().max().item())
            agree.append((lo.argmax(-1) == hi.argmax(-1)).float().mean()
                         .item())
            tokens = hi.argmax(-1).to(torch.int32)
            positions = positions + 1
    return band, float(np.mean(agree)), scale


#: int8 KV pages against fp32 pages in quant-parity: the decode logits'
#: band as a share of the largest |logit|, and the least share of
#: positions whose argmax agrees.  An int8 row keeps each value to half
#: of 1/127 of its block's largest; the readings were 0.4% of the logit
#: scale and 100% agreement, so 2% leaves room while a wrong scale slice
#: or block (errors on the logit scale itself) fails, and 98% lets one
#: of the 96 positions flip on a near-tie.
KV_BAND_MAX = 0.02
KV_AGREE_MIN = 0.98


def phase_quant_parity(dev) -> None:
    """Quantized serving at the flagship's width, 2 layers, fp32 compute,
    phase 3's 6 ragged requests through 2 slots, 16 new tokens: from int8
    and int4 weight pools (the flagship) and int4 (the Llama mode, with
    its ``fc_gate``), the paged greedy tokens must equal
    ``generate_reference`` on the same quantized model, both through the
    dequant kernels; from int8 KV pages (fp32 weights) every request must
    complete, and the decode logits are held against fp32 pages."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.models.gpt import quantize_gpt_weights
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[quant-parity] 2 layers at the flagship's width, fp32: paged "
        "greedy from quantized pools vs full recompute on the same pools")
    new = 16
    plens = np.array([48, 17, 64, 5, 33, 60])
    rng = np.random.RandomState(2)
    for label, sizes, widths in (("flagship", FLAGSHIP, ("int8", "int4")),
                                 ("Llama mode", LLAMA, ("int4",))):
        cfg = GPTConfig(**dict(sizes, num_layers=2),
                        compute_dtype=torch.float32)
        model = GPTModel(cfg, device=dev, seed=1)
        prompts = rng.randint(1, cfg.vocab_size, (6, 64)).astype(np.int32)
        for i, n in enumerate(plens):
            prompts[i, n:] = 0
        reqs = [Request(uid=i, prompt=prompts[i, :n].tolist(),
                        max_new_tokens=new) for i, n in enumerate(plens)]
        for wd in widths:
            qm = quantize_gpt_weights(model, wd)
            ref = qm.generate_reference(prompts, plens, new)
            torch.cuda.synchronize()
            reset_launch_counts()
            comps, _, _, _ = serve(qm, reqs, max_prompt_len=64, page_size=16,
                                   max_seqs=2, pages_per_seq=5,
                                   harvest_every=4)
            torch.cuda.synchronize()
            counts = launch_counts()
            for i in range(6):
                if comps[i].tokens != ref[i].tolist():
                    fail(f"quant-parity: {label} {wd} request {i} paged "
                         f"{comps[i].tokens} != reference "
                         f"{ref[i].tolist()}")
            if counts.get(f"dequant_{wd}", 0) <= 0:
                fail(f"quant-parity: dequant_{wd} never launched")
            distinct = len({t for r in ref.tolist() for t in r})
            log(f"  {label}, {wd} weights: 6 requests x {new} tokens "
                f"identical ({distinct} distinct ids); launches {counts}")
        if label != "flagship":
            continue
        reset_launch_counts()
        comps, _, _, _ = serve(model, reqs, max_prompt_len=64, page_size=16,
                               max_seqs=2, pages_per_seq=5, harvest_every=4,
                               kv_dtype=torch.int8)
        torch.cuda.synchronize()
        counts = launch_counts()
        for i in range(6):
            toks = comps[i].tokens
            if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
                fail(f"quant-parity: int8 KV request {i} returned {toks}")
        if counts.get("paged_decode_int8", 0) <= 0:
            fail("quant-parity: paged_decode_int8 never launched")
        band, agree, scale = kv_logit_band(model, prompts, plens, new)
        log(f"  {label}, int8 KV pages (fp32 weights): 6 requests x {new} "
            f"tokens complete; decode logits vs fp32 pages over {new} "
            f"steps: max |diff| {band:.5f} (logit scale {scale:.3f}), "
            f"argmax agrees at {100 * agree:.1f}% of positions")
        if not band <= KV_BAND_MAX * scale or agree < KV_AGREE_MIN:
            fail(f"quant-parity: int8 KV logits off fp32 pages by {band:.5f}"
                 f" (limit {KV_BAND_MAX * scale:.5f}) or argmax agreeing at "
                 f"{100 * agree:.1f}% (limit {100 * KV_AGREE_MIN:.0f}%)")
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
    # then one request past the short rung: a 900-token prompt, prefill
    # padded to 960 through mid_fwd
    long_req = Request(uid="long",
                       prompt=rng.randint(1, cfg.vocab_size, 900).tolist(),
                       max_new_tokens=new)
    long_comps, long_wall, long_prefill, _ = serve(model, [long_req], 960,
                                                   64, 1, 16)
    counts = launch_counts()
    toks = long_comps["long"].tokens
    if len(toks) != new or not all(0 <= t < cfg.vocab_size for t in toks):
        fail(f"serve: the 900-token request returned {toks}")
    log(f"  a 900-token prompt (prefill padded to 960, mid rung): {new} "
        f"tokens in {long_wall:.3f} s, prefill {1e3 * long_prefill[0]:.2f} "
        "ms")
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
    for name in ("ln_fwd", "short_fwd", "mid_fwd", "paged_decode"):
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


def phase_serve_long(dev):
    """The 12-layer Llama-mode GPT in bf16 serves four requests of 2300,
    1500, 700 and 64 prompt tokens, 32 greedy tokens each, 4 slots, pages
    of 64: every prefill is padded to 2304 tokens (the flash rung) and
    every decode step rotates q in the paged kernel.  Returns the
    model."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[serve-long] Llama-mode GPT, 12 layers, bf16: 4 requests of "
        "64..2300 prompt tokens x 32 tokens, 4 slots, pages 64 x 37")
    cfg = GPTConfig(**LLAMA, compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device=dev, seed=0)
    rng = np.random.RandomState(6)
    plens, new, width, pps = [2300, 1500, 700, 64], 32, 2304, 37
    reqs = [Request(uid=i, prompt=rng.randint(1, cfg.vocab_size, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    serve(model, [Request(uid="warm", prompt=[1, 2, 3], max_new_tokens=2)],
          width, 64, 4, pps)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    comps, wall, prefill_s, batcher = serve(model, reqs, width, 64, 4, pps)
    torch.cuda.synchronize()
    counts = launch_counts()
    for i in range(len(reqs)):
        toks = comps[i].tokens
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            fail(f"serve-long: request {i} returned {toks}")
    decode_s = wall - sum(prefill_s)
    log(f"  {len(reqs)} requests complete, {batcher.steps} decode steps, "
        f"wall {wall:.3f} s; prefill of {width} tokens "
        f"{1e3 * np.mean(prefill_s):.2f} ms each; decode "
        f"{1e3 * decode_s / batcher.steps:.2f} ms per step (4 slots)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches in this phase: {counts}")
    for name in ("ln_fwd", "flash_fwd", "paged_decode"):
        if counts.get(name, 0) <= 0:
            fail(f"serve-long: kernel {name} never launched on the main path")
    phase_profile(model, prompt=2300, width=width, pps=pps,
                  what="Llama-mode GPT")
    return model


def phase_serve_quant(model) -> dict:
    """Phase 4's model and requests (12-layer flagship, bf16 compute, 8
    requests of 32..512 tokens x 32 new tokens, 4 slots, pages 64 x 9)
    served from weights {bf16 copies made once, int8, int4} x KV pages
    {bf16, int8}.  Every request must complete, and the dequant kernels
    and the int8-page decode kernel must launch.  Then one decode window
    profiled with the bf16 copies (phase 5's ran without them) and one at
    int4 weights with int8 KV.  Returns the launches of the six runs."""
    from apex_tpu_torch.models.gpt import quantize_gpt_weights
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[serve-quant] flagship GPT, 12 layers, bf16: weights {bf16, int8, "
        "int4} x KV {bf16, int8}, 8 requests x 32 tokens, 4 slots, pages "
        "64 x 9")
    c, dev = model.config, model.device
    plens = np.linspace(32, 512, 8).astype(int)
    rng = np.random.RandomState(0)
    new = 32
    reqs = [Request(uid=i, prompt=rng.randint(1, c.vocab_size, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    served = {"bf16": model}
    for wd in ("int8", "int4"):
        served[wd] = quantize_gpt_weights(model, wd)
    # the quantized logits against bf16 weights on one fixed prompt
    toks = torch.as_tensor([reqs[3].prompt], device=dev)
    with torch.no_grad():
        ref = model.apply(toks)[0].float()
        for wd in ("int8", "int4"):
            lo = served[wd].apply(toks)[0].float()
            agree = (lo.argmax(-1) == ref.argmax(-1)).float().mean().item()
            log(f"  {wd} vs bf16 weights, logits over a {toks.shape[1]}-token "
                f"prompt: max |diff| {(lo - ref).abs().max().item():.4f} "
                f"(logit scale {ref.abs().max().item():.3f}), argmax agrees "
                f"at {100 * agree:.1f}% of positions")
    serve(served["int4"], [Request(uid="warm", prompt=[1, 2, 3],
                                   max_new_tokens=2)], 512, 64, 4, 9,
          weight_dtype="int4", kv_dtype=torch.int8)
    torch.cuda.synchronize()
    reset_launch_counts()
    for wd in ("bf16", "int8", "int4"):
        for kv_dtype in (None, torch.int8):
            comps, wall, prefill_s, b = serve(
                served[wd], reqs, 512, 64, 4, 9, weight_dtype=wd,
                kv_dtype=kv_dtype)
            for i in range(len(reqs)):
                got = comps[i].tokens
                if len(got) != new or not all(0 <= t < c.vocab_size
                                              for t in got):
                    fail(f"serve-quant: {wd} weights request {i} returned "
                         f"{got}")
            step_s = (wall - sum(prefill_s)) / b.steps
            wbytes = b.decode_fn.weight_stream_bytes
            kv_bytes = sum(p.numel() * p.element_size()
                           for p in b.pools.values())
            log(f"  weights {wd} ({b.decode_fn.weight_dtype}), KV "
                f"{'int8' if kv_dtype else 'bf16'}: decode "
                f"{1e3 * step_s:.2f} ms/step, prefill "
                f"{1e3 * np.mean(prefill_s):.2f} ms each; a decode step "
                f"streams {wbytes / 1e6:.1f} MB of weights = "
                f"{wbytes / step_s / 1e9:.1f} GB/s; KV pool "
                f"{kv_bytes / 1e6:.1f} MB")
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  launches in the six runs: {counts}")
    for name in ("dequant_int8", "dequant_int4", "paged_decode_int8",
                 "paged_decode", "short_fwd", "ln_fwd"):
        if counts.get(name, 0) <= 0:
            fail(f"serve-quant: kernel {name} never launched")
    phase_profile(model, what="flagship GPT, bf16 weight copies made once",
                  weight_dtype="bf16")
    phase_profile(served["int4"], what="flagship GPT, int4 weights, int8 KV",
                  kv_dtype=torch.int8)
    return counts


def phase_serve_quant_long(model) -> None:
    """Serve-long's model and four requests (64..2300 prompt tokens,
    prefill padded to 2304 on the flash rung) from int8 weights and int8
    KV pages: the dequant kernels take m=2304 in prefill."""
    from apex_tpu_torch.models.gpt import quantize_gpt_weights
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[serve-quant-long] Llama-mode GPT, 12 layers, bf16, int8 weights "
        "and int8 KV: 4 requests of 64..2300 prompt tokens x 32 tokens")
    c = model.config
    rng = np.random.RandomState(6)
    plens, new, width, pps = [2300, 1500, 700, 64], 32, 2304, 37
    reqs = [Request(uid=i, prompt=rng.randint(1, c.vocab_size, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    qm = quantize_gpt_weights(model, "int8")
    torch.cuda.synchronize()
    reset_launch_counts()
    comps, wall, prefill_s, b = serve(qm, reqs, width, 64, 4, pps,
                                      weight_dtype="int8",
                                      kv_dtype=torch.int8)
    torch.cuda.synchronize()
    counts = launch_counts()
    for i in range(len(reqs)):
        got = comps[i].tokens
        if len(got) != new or not all(0 <= t < c.vocab_size for t in got):
            fail(f"serve-quant-long: request {i} returned {got}")
    for name in ("dequant_int8", "paged_decode_int8", "flash_fwd"):
        if counts.get(name, 0) <= 0:
            fail(f"serve-quant-long: kernel {name} never launched")
    log(f"  {len(reqs)} requests complete, {b.steps} decode steps; prefill "
        f"of {width} tokens {1e3 * np.mean(prefill_s):.2f} ms each; decode "
        f"{1e3 * (wall - sum(prefill_s)) / b.steps:.2f} ms per step; "
        f"launches {counts}")


def device_rows(prof) -> list:
    """``(device us, calls, name)`` of each kernel and device copy in a
    ``torch.profiler`` run: an aten op's own entry repeats the device
    time of the kernels it launched, and a user annotation on the device
    timeline (``tlm.*`` phases, ``Optimizer.step#...``) spans the
    kernels inside it, so neither is counted."""
    from apex_tpu_torch.telemetry import PHASE_PREFIX

    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith(PHASE_PREFIX)
                or e.key.startswith("Optimizer.")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t, e.count, e.key))
    return rows


def device_breakdown(prof, wall_s: float, label: str) -> None:
    """Device busy share and the kernels that took the device's time,
    from a ``torch.profiler`` run of ``wall_s`` seconds."""
    rows = device_rows(prof)
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
def phase_profile(model, prompt=256, width=512, pps=9,
                  what="flagship GPT", weight_dtype=None,
                  kv_dtype=None) -> None:
    """Where the serving time goes: 4 prefills of ``prompt``-token
    prompts (padded to ``width``), then one harvest window of 8 decode
    steps over 4 slots, each under ``torch.profiler``, with the weights
    of ``decode_fns(weight_dtype=)`` and the pages of ``kv_dtype``."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, Request,
        init_pools)

    log(f"[profile] {what}, bf16: 4 prefills ({prompt} tokens, padded to "
        f"{width}), then 8 decode steps x 4 slots")
    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + 4 * pps, page_size=64, max_seqs=4,
        pages_per_seq=pps, dtype=c.compute_dtype, kv_dtype=kv_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=width,
                           weight_dtype=weight_dtype)
    batcher = ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg),
        init_pools(ccfg, model.device), max_prompt_len=width,
        harvest_every=8)
    rng = np.random.RandomState(1)
    queue = collections.deque(
        Request(uid=i, prompt=rng.randint(1, c.vocab_size, prompt).tolist(),
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


# ---------------------------------------------------------------- phase 6
def phase_train_parity(dev) -> dict:
    """One training step (loss, backward, FusedAdam) at the flagship's
    width, 2 layers and fp32, on the GPU through the kernels and on a
    CPU copy of the same model and state through the plain versions
    (``device="cpu"``, chosen explicitly), batch 1: the flagship at s=384
    (short rung) and s=640 (mid rung), the Llama mode at s=2560 (flash
    rung).  Returns each case's launch counts."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam

    lr = 1e-3
    log("[train-parity] flagship width, 2 layers, fp32 (O0): one step on "
        f"the GPU vs the CPU, FusedAdam lr={lr}")
    flagship = GPTConfig(**dict(FLAGSHIP, num_layers=2),
                         policy=get_policy("O0"))
    llama = GPTConfig(**dict(LLAMA, num_layers=2), policy=get_policy("O0"))
    counts = {}
    for s, cfg, need in ((384, flagship, ("short_fwd", "short_bwd")),
                         (640, flagship, ("mid_fwd", "mid_bwd")),
                         (2560, llama, ("flash_fwd", "flash_bwd_dkv",
                                        "flash_bwd_dq"))):
        gpu = GPTModel(cfg, device=dev, seed=3)
        cpu = GPTModel(cfg, device="cpu", seed=3)
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        before = {k: v.cpu().clone() for k, v in gpu.state_dict().items()}
        toks = np.random.RandomState(s).randint(0, cfg.vocab_size, (1, s))
        tgts = np.roll(toks, -1, axis=1)
        out = []
        for model in (gpu, cpu):
            opt = FusedAdam(model.parameters(), lr=lr)
            t, y = (torch.as_tensor(a, device=model.device)
                    for a in (toks, tgts))
            if model is gpu:
                torch.cuda.synchronize()
                reset_launch_counts()
            loss = model.loss(t, y)
            loss.backward()
            opt.step()
            if model is gpu:
                torch.cuda.synchronize()
                counts[s] = launch_counts()
            out.append((loss.item(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()},
                        {n: p.detach().cpu() for n, p in
                         model.named_parameters()}))
        (lg, gg, pg), (lc, gc, pc) = out
        if not abs(lg - lc) <= 1e-5 * max(1.0, abs(lc)):
            fail(f"train-parity s={s}: loss {lg} (GPU) vs {lc} (CPU)")
        worst_g, worst_p, steps_checked = 0.0, 0.0, 0
        for n in gc:
            # fp32 on both sides, sums in another order: 1e-4 of the
            # tensor's largest gradient
            tol = 1e-4 * gc[n].abs().max().item() + 1e-9
            err = (gg[n] - gc[n]).abs().max().item()
            worst_g = max(worst_g, err / tol)
            if err > tol:
                fail(f"train-parity s={s}: grad {n} differs by {err:.3g} > "
                     f"{tol:.3g}")
            # the first Adam step moves a weight by lr * g / (|g| + eps):
            # where |g| is 10x the gradient tolerance and 1e-6 the sign
            # is sure and the steps agree to 1% of lr; elsewhere (noise,
            # such as the key bias's exactly-zero gradient) only the
            # bound |step| <= lr holds
            sure = gc[n].abs() >= max(10 * tol, 1e-6)
            dp = (pg[n] - pc[n]).abs()
            steps_checked += int(sure.sum())
            if sure.any():
                worst_p = max(worst_p, dp[sure].max().item() / (1e-2 * lr))
            if (dp[sure] > 1e-2 * lr).any() or (
                    (pg[n] - before[n]).abs().max() > 1.001 * lr):
                fail(f"train-parity s={s}: updated {n} differs by "
                     f"{dp.max().item():.3g}")
        c = counts[s]
        log(f"  s={s} ({cfg.position_embedding}, {cfg.activation}): loss "
            f"{lg:.6f} (GPU) vs {lc:.6f} (CPU); every grad "
            f"within 1e-4 of its scale (worst {worst_g:.3f} of the "
            f"tolerance); updated params within 1% of a step at "
            f"{steps_checked} sure-sign elements (worst {worst_p:.3f} of "
            f"it); launches {c}")
        for name in need + ("ln_fwd",):
            if c.get(name, 0) <= 0:
                fail(f"train-parity s={s}: kernel {name} never launched")
        del gpu, cpu
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 7
#: the trainer flags of the two training cells (the JAX trainer's defaults
#: are vocab 32768, 12 layers, hidden 1024, 8 heads)
TRAIN_FLAGSHIP = ["--seq", "1024", "--micro-batch", "8", "--num-micro", "1"]
TRAIN_LONG = ["--position-embedding", "rope", "--activation", "swiglu",
              "--normalization", "rmsnorm", "--seq", str(LONG_SEQ),
              "--micro-batch", "2", "--num-micro", "1"]


def phase_train(dev, flags=TRAIN_FLAGSHIP, label="train",
                need=("ln_fwd", "mid_fwd", "mid_bwd")):
    """A 12-layer GPT at O5 (bf16 params and compute, fp32 norms and
    masters), remat on, through the port trainer's step as ``gpt_pretrain
    <flags>`` builds it (the flagship, 8 x 1024 tokens, by default): 2
    warm-up steps, then 10 timed steps on a repeated batch; the kernels
    in ``need`` must have launched."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.telemetry import mfu

    args = gpt_pretrain.parse_args(flags + [
        "--opt-level", "O5", "--lr", "3e-4", "--device", str(dev)])
    log(f"[{label}] gpt_pretrain {' '.join(flags)}: 12 layers, O5, remat "
        "on, 2 warm-up + 10 timed steps of the port trainer on one batch")
    tr = gpt_pretrain.Trainer(args)
    batch = tr.to_device(*gpt_pretrain.batches(
        np.random.default_rng(0), 1, tr.global_batch, args.seq,
        args.vocab)[0])
    # bf16 vs fp32 loss at step 1 from the same weights
    ref = GPTModel(dataclasses.replace(tr.model.config,
                                       policy=get_policy("O0")), device=dev)
    ref.load_state_dict({k: v.float() for k, v in
                         tr.model.state_dict().items()})
    with torch.no_grad():
        loss_fp32 = ref.loss(*batch).item()
    del ref
    torch.cuda.empty_cache()
    warm = [tr.step(*batch) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [tr.step(*batch) for _ in range(10)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in torch.stack(warm + losses).cpu()]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[2] < losses[0]:
        fail(f"{label}: losses {losses} are not finite and falling")
    ms = 1e3 * wall / 10
    tps = tr.tokens_per_step / (ms / 1e3)
    util = mfu(tps, tr.flops_per_token, PEAK_OPS_PER_S[torch.bfloat16])
    log(f"  step 1 loss: {losses[0]:.5f} at O5 vs {loss_fp32:.5f} at fp32 "
        f"from the same weights (|diff| {abs(losses[0] - loss_fp32):.5f})")
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {ms:.2f} ms/step, {tps:,.0f} tokens/s, MFU {util:.4f} against "
        f"the 989 TFLOP/s bf16 dense peak ({tr.n_params:,} params, the "
        f"SwiGLU gate included where there is one; {tr.flops_per_token:,} "
        f"model FLOPs per token, 6·N + 12·L·h·s at s={args.seq})")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    log(f"  launches in the 10 timed steps: {counts} (per step: "
        + ", ".join(f"{k} {v / 10:g}" for k, v in sorted(counts.items()))
        + ")")
    for name in need:
        if counts.get(name, 0) <= 0:
            fail(f"{label}: kernel {name} never launched on the main path")
    return counts, tr, batch


def phase_profile_train(tr, batch, what="flagship (O5, 8 x 1024)") -> None:
    """Where a training step's time goes: one step under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    log(f"[profile] one training step, {what}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_breakdown(prof, wall, "train step")
    host = [e for e in prof.key_averages()
            if e.key.startswith("Optimizer.step")
            and e.device_type == torch.autograd.DeviceType.CPU]
    if host:
        log(f"  host time inside {host[0].key}: "
            f"{host[0].cpu_time_total / 1e3:.2f} ms")


SOURCES = {
    "ln_fwd": ("triton", "apex_tpu_torch/ops/layer_norm.py",
               "apex_tpu/ops/layer_norm.py:66"),
    "short_fwd": ("cuda", "apex_tpu_torch/csrc/attention_short.cu",
                  "apex_tpu/ops/attention_short.py:149"),
    "paged_decode": ("cuda", "apex_tpu_torch/csrc/attention_decode.cu",
                     "apex_tpu/ops/attention_decode.py:210"),
    "short_bwd": ("cuda", "apex_tpu_torch/csrc/attention_short.cu",
                  "apex_tpu/ops/attention_short.py:215"),
    "mid_fwd": ("cuda", "apex_tpu_torch/csrc/attention_mid.cu",
                "apex_tpu/ops/attention_mid.py:213"),
    "mid_bwd": ("cuda", "apex_tpu_torch/csrc/attention_mid.cu",
                "apex_tpu/ops/attention_mid.py:308"),
    "flash_fwd": ("cuda", "apex_tpu_torch/csrc/attention_flash.cu",
                  "apex_tpu/ops/attention.py:213"),
    "flash_bwd_dkv": ("cuda", "apex_tpu_torch/csrc/attention_flash.cu",
                      "apex_tpu/ops/attention.py:429"),
    "flash_bwd_dq": ("cuda", "apex_tpu_torch/csrc/attention_flash.cu",
                     "apex_tpu/ops/attention.py:534"),
    "dequant_int8": ("cuda", "apex_tpu_torch/csrc/dequant_matmul.cu",
                     "apex_tpu/ops/dequant_matmul.py:97"),
    "dequant_int4": ("cuda", "apex_tpu_torch/csrc/dequant_matmul.cu",
                     "apex_tpu/ops/dequant_matmul.py:107"),
    "paged_decode_int8": ("cuda", "apex_tpu_torch/csrc/attention_decode.cu",
                          "apex_tpu/ops/attention_decode.py:210"),
}

FLASH = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def timed(label, fn, *args):
    """Run one phase and log its wall time (the script has 1200 s)."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"({label}: {time.perf_counter() - t0:.1f} s)")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs on the GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    card = timed("build", phase_build)
    records = timed("kernels", phase_kernels, dev)
    timed("parity", phase_parity, dev)
    timed("rope-parity", phase_rope_parity, dev)
    timed("quant-parity", phase_quant_parity, dev)
    serve_counts, model = timed("serve", phase_serve, dev)
    timed("profile", phase_profile, model)
    quant_counts = timed("serve-quant", phase_serve_quant, model)
    del model
    torch.cuda.empty_cache()
    model = timed("serve-long", phase_serve_long, dev)
    timed("serve-quant-long", phase_serve_quant_long, model)
    del model
    torch.cuda.empty_cache()
    parity_counts = timed("train-parity", phase_train_parity, dev)
    train_counts, tr, batch = timed("train", phase_train, dev)
    timed("profile", phase_profile_train, tr, batch)
    del tr, batch
    torch.cuda.empty_cache()
    long_counts, tr, batch = timed(
        "train-long", phase_train, dev, TRAIN_LONG, "train-long",
        ("ln_fwd",) + FLASH)
    timed("profile", phase_profile_train, tr, batch,
          f"Llama mode (O5, 2 x {LONG_SEQ})")
    # one record per kernel at its main path's shape; launches from the
    # path that carries it: the serving kernels from phase 4, the dequant
    # kernels and int8 pages from serve-quant, short_bwd from the s=384
    # training step of phase 6, the mid kernels from the flagship training
    # of phase 7, the flash kernels from the long-context training of
    # phase 9
    main_counts = dict(serve_counts)
    for name in ("dequant_int8", "dequant_int4", "paged_decode_int8"):
        main_counts[name] = quant_counts.get(name, 0)
    main_counts["short_bwd"] = parity_counts[384].get("short_bwd", 0)
    for name in ("mid_fwd", "mid_bwd"):
        main_counts[name] = train_counts.get(name, 0)
    for name in FLASH:
        main_counts[name] = long_counts.get(name, 0)
    kernels = [dict(name=name, route=route, source=source,
                    replaces=replaces, launches=main_counts.get(name, 0),
                    **records[name][0])
               for name, (route, source, replaces) in SOURCES.items()]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
