"""Kernel validation on the H100: every port kernel's error against an
fp32 reference and its device time beside the PyTorch call that computes
the same function.

The port's twin of the root ``tools/kernel_validation.py`` (the JAX
package's pallas-vs-XLA cross-check), on the JAX tool's shapes, with its
entry kinds (``flash_attention``, ``fmha_short``, ``fmha_mid``,
``fused_layer_norm``, ``scaled_softmax``,
``scaled_upper_triang_masked_softmax``, ``fused_dense``,
``fused_dense_gelu_dense``, ``mlp``, ``opt_tail``, ``fmha_decode``,
``decode_generation``, ``dequant_matmul``):

- attention: every rung (short, mid, flash) at every s of
  :data:`ATTENTION_SEQS` it takes, forward and forward+backward, bf16
  and fp16, causal and not, 8192 tokens a case (b = 8192 / s, 8 heads of
  128), beside ``F.scaled_dot_product_attention``;
- the layer norm beside ``F.layer_norm``, the softmax beside
  ``torch.softmax``, the dense layers and the MLP beside ``F.linear``
  (+ ``F.gelu``), the Adam tail beside ``torch._fused_adamw_``, the
  dequant pair beside a dense ``torch.matmul`` (a separate reading: it
  reads the wide weights), the paged decode (no PyTorch call takes the
  paged layout);
- the generation identities: greedy paged, chunked with the prefix
  cache and speculative generation equal to the full-recompute
  reference (fp32, so a near tie cannot split them).

Times are device ms a call: the kernels' device time summed by
``torch.profiler`` over several calls (CUDA events over eager calls,
host gaps included, when CUPTI hands a session no device records; the
entry says which).  The plain versions' time is no yardstick and is not
taken.

The gates: the numeric gate (1) (an error over 5x the library's, or
1e-3, or a gradient over 0.1 relative) and the identity gate (6) fail
the run.  The JAX tool's crossover gates (3), (3b) and (5) and its speed
gate (2) encode TPU crossovers that do not carry over to the card; here
they are computed from the card's numbers and written as findings (the s
where each rung should hand over, against ``short_seq_threshold()`` and
``mid_seq_threshold()``; kernels slower than their library call).
``--strict`` makes the findings fail too.  Gate (4) ("2x flash at the
flagship shape") is a TPU number and is not carried over.

    python -m apex_tpu_torch.tools.kernel_validation --out tool_out/kernel_validation.json
    python -m apex_tpu_torch.tools.kernel_validation --smoke
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the JAX tool's entry kinds, each of which this tool writes
ENTRY_KINDS = ("flash_attention", "fmha_short", "fmha_mid",
               "fused_layer_norm", "scaled_softmax",
               "scaled_upper_triang_masked_softmax", "fused_dense",
               "fused_dense_gelu_dense", "mlp", "opt_tail", "fmha_decode",
               "decode_generation", "dequant_matmul")
ATTENTION_SEQS = (128, 256, 384, 512, 1024, 2048, 4096, 8192)
ATTENTION_TOKENS, HEADS, HEAD_DIM = 8192, 8, 128
#: rung -> (entry kind, the implementation name that forces it)
RUNGS = {"short": ("fmha_short", "short"), "mid": ("fmha_mid", "mid"),
         "flash": ("flash_attention", "pallas")}
PROFILE_TRIES = 3
NUMERIC_FACTOR, NUMERIC_FLOOR, GRAD_REL_LIMIT = 5.0, 1e-3, 0.1


# ------------------------------------------------------------------ timing
def device_ms(fn: Callable, iters: int = 10) -> Tuple[float, str]:
    """``(ms, how)``: device ms a call of ``fn``, the kernels' device time
    summed by ``torch.profiler`` over ``iters`` calls after a warm-up
    (``how`` "profiler"), or CUDA events over the eager calls when no
    session got device records (``how`` "events": host gaps included)."""
    from torch.profiler import ProfilerActivity, profile

    def loop():
        for _ in range(iters):
            fn()

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loop()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
        if us > 0:
            return us / 1e3 / iters, "profiler"
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loop()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, "events"


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _rel(grads, refs) -> float:
    return max(_err(g, r) / (float(r.float().abs().max()) + 1e-6)
               for g, r in zip(grads, refs))


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


# --------------------------------------------------------------- attention
def _rungs_for(s: int) -> List[str]:
    from apex_tpu_torch.ops.attention_mid import (
        FMHA_MID_MAX_SEQ,
        mid_seq_threshold,
    )
    from apex_tpu_torch.ops.attention_short import (
        FMHA_SHORT_MAX_SEQ,
        short_seq_threshold,
    )

    out = []
    if s <= max(FMHA_SHORT_MAX_SEQ, short_seq_threshold()):
        out.append("short")
    if s <= max(FMHA_MID_MAX_SEQ, mid_seq_threshold()):
        out.append("mid")
    return out + ["flash"]


def _auto_rung(s: int) -> str:
    from apex_tpu_torch.ops.attention_mid import mid_seq_threshold
    from apex_tpu_torch.ops.attention_short import short_seq_threshold

    if s <= short_seq_threshold():
        return "short"
    return "mid" if s <= mid_seq_threshold() else "flash"


def _fwd_bwd(call, q, k, v, dout):
    def run():
        out = call(q, k, v)
        return torch.autograd.grad(out, (q, k, v), dout)
    return run


#: the smoke run's one shape a rung: (s, rung), bf16, causal
SMOKE_ATTENTION = ((512, "short"), (1024, "mid"), (4096, "flash"))


def validate_attention(smoke: bool = False, seqs=ATTENTION_SEQS,
                       dtypes=(torch.bfloat16, torch.float16),
                       device=None, iters: int = 10,
                       tokens: int = ATTENTION_TOKENS, heads: int = HEADS,
                       head_dim: int = HEAD_DIM,
                       rungs=("short", "mid", "flash")) -> List[Dict]:
    """Every rung of ``rungs`` at every s it takes, forward and
    forward+backward, beside SDPA, with the error against the fp32
    reference (the JAX loss ``sum(out**2)``'s gradients); b = ``tokens``
    / s."""
    from apex_tpu_torch.ops.attention import flash_attention, mha_reference

    device = device or torch.device("cuda", torch.cuda.current_device())
    cases = [(s, dt, c, [r for r in _rungs_for(s) if r in rungs])
             for s in seqs for dt in dtypes for c in (True, False)]
    if smoke:
        cases = [(s, torch.bfloat16, True, [r]) for s, r in SMOKE_ATTENTION
                 if r in rungs]
    results = []
    for s, dtype, causal, case_rungs in cases:
        if not case_rungs:
            continue
        b = max(1, tokens // s)
        shape = (b, heads, s, head_dim)
        q, k, v = (_randn(shape, dtype, device, i).requires_grad_()
                   for i in range(3))
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        ref = mha_reference(qf, kf, vf, causal=causal)
        ref_grads = torch.autograd.grad((ref * ref).sum(), (qf, kf, vf))
        ref = ref.detach()
        dout = (2.0 * ref).to(dtype)       # d sum(out^2) / d out, at the ref
        del qf, kf, vf

        def sdpa(q_, k_, v_):
            return F.scaled_dot_product_attention(q_, k_, v_,
                                                  is_causal=causal)

        lib_out = sdpa(q, k, v).detach()
        lib_grads = _fwd_bwd(sdpa, q, k, v, dout)()
        lib_fwd_ms, how = device_ms(lambda: sdpa(q, k, v), iters)
        lib_fb_ms, how_b = device_ms(_fwd_bwd(sdpa, q, k, v, dout), iters)
        lib_err, lib_gerr = _err(lib_out, ref), _rel(lib_grads, ref_grads)
        flops = (2.0 if causal else 4.0) * b * heads * s * s * head_dim
        for rung in case_rungs:
            kind, impl = RUNGS[rung]

            def call(q_, k_, v_, impl=impl):
                return flash_attention(q_, k_, v_, causal=causal,
                                       implementation=impl)

            out = call(q, k, v).detach()
            grads = _fwd_bwd(call, q, k, v, dout)()
            f_ms, how_f = device_ms(lambda: call(q, k, v), iters)
            fb_ms, how_fb = device_ms(_fwd_bwd(call, q, k, v, dout), iters)
            rec = {
                "kernel": kind, "rung": rung, "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "causal": causal, "auto_impl": _auto_rung(s),
                "fwd": {"kernel_ms": round(f_ms, 4),
                        "library_ms": round(lib_fwd_ms, 4),
                        "speedup": round(lib_fwd_ms / f_ms, 3),
                        "kernel_tflops": round(flops / f_ms / 1e9, 1),
                        "max_err_vs_fp32": _err(out, ref),
                        "library_err_vs_fp32": lib_err},
                "fwd_bwd": {"kernel_ms": round(fb_ms, 4),
                            "library_ms": round(lib_fb_ms, 4),
                            "speedup": round(lib_fb_ms / fb_ms, 3),
                            "grad_max_rel_err": _rel(grads, ref_grads),
                            "library_grad_max_rel_err": lib_gerr},
                "timing": sorted({how, how_b, how_f, how_fb}),
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)
        del q, k, v, ref, ref_grads, lib_grads
        torch.cuda.empty_cache()
    return results


def validate_flash(smoke: bool = False, **kw) -> List[Dict]:
    """The flash rung's sweep (:func:`validate_attention`)."""
    return validate_attention(smoke, rungs=("flash",), **kw)


def validate_fmha_short(smoke: bool = False, **kw) -> List[Dict]:
    """The short rung's sweep (:func:`validate_attention`)."""
    return validate_attention(smoke, rungs=("short",), **kw)


def validate_fmha_mid(smoke: bool = False, **kw) -> List[Dict]:
    """The mid rung's sweep (:func:`validate_attention`)."""
    return validate_attention(smoke, rungs=("mid",), **kw)


def crossovers(entries: List[Dict]) -> Dict:
    """From the attention rows: for each dtype and causality, the fastest
    rung at each s (forward and forward+backward), the ladder's pick, and
    the first s where the next rung beats the one before it: where each
    rung should hand over, beside ``short_seq_threshold()`` /
    ``mid_seq_threshold()``."""
    from apex_tpu_torch.ops.attention_mid import mid_seq_threshold
    from apex_tpu_torch.ops.attention_short import short_seq_threshold

    table: Dict = {}
    for e in entries:
        if e.get("kernel") not in ("flash_attention", "fmha_short",
                                   "fmha_mid"):
            continue
        key = f"{e['dtype']} {'causal' if e['causal'] else 'full'}"
        cell = table.setdefault(key, {}).setdefault(e["shape"][2], {})
        for part in ("fwd", "fwd_bwd"):
            cell.setdefault(part, {})[e["rung"]] = e[part]["kernel_ms"]
            cell.setdefault(part, {})["sdpa"] = e[part]["library_ms"]
        cell["auto"] = e["auto_impl"]
    out = {"short_seq_threshold": short_seq_threshold(),
           "mid_seq_threshold": mid_seq_threshold(), "by_case": {}}
    for key, by_s in table.items():
        case = {"fastest": {}, "hand_over": {}}
        for part in ("fwd", "fwd_bwd"):
            fastest = {}
            for s, cell in sorted(by_s.items()):
                ms = {r: t for r, t in cell[part].items() if r != "sdpa"}
                fastest[s] = min(ms, key=ms.get)
            case["fastest"][part] = fastest
            for lo, hi in (("short", "mid"), ("mid", "flash")):
                over = [s for s, cell in sorted(by_s.items())
                        if lo in cell[part] and hi in cell[part]
                        and cell[part][hi] < cell[part][lo]]
                case["hand_over"][f"{part} {lo}->{hi}"] = (
                    over[0] if over else None)
        out["by_case"][key] = case
    return out


# ------------------------------------------------------------ layer norm
def validate_layer_norm(smoke=False, device=None, iters=10,
                        shapes=((16384, 1024), (8192, 4096), (4096, 8192)),
                        dtypes=(torch.bfloat16, torch.float32)
                        ) -> List[Dict]:
    from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine

    device = device or torch.device("cuda", torch.cuda.current_device())
    if smoke:
        shapes, dtypes = shapes[:1], dtypes[:1]
    results = []
    for rows, hidden in shapes:
        for dtype in dtypes:
            x = _randn((rows, hidden), dtype, device, 1)
            w = torch.ones(hidden, device=device)
            bias = torch.zeros(hidden, device=device)
            ref = F.layer_norm(x.float(), (hidden,), w, bias, 1e-5)
            run = lambda: fused_layer_norm_affine(x, w, bias, (hidden,),
                                                  1e-5)
            lib = lambda: F.layer_norm(x, (hidden,), w.to(dtype),
                                       bias.to(dtype), 1e-5)
            k_ms, how = device_ms(run, iters)
            l_ms, _ = device_ms(lib, iters)
            gb = 2 * rows * hidden * x.element_size() / 1e9
            results.append({
                "kernel": "fused_layer_norm", "shape": [rows, hidden],
                "dtype": str(dtype).replace("torch.", ""),
                "kernel_ms": round(k_ms, 4), "library_ms": round(l_ms, 4),
                "speedup": round(l_ms / k_ms, 3),
                "kernel_gbps": round(gb / (k_ms / 1e3), 1),
                "max_err_vs_fp32": _err(run(), ref),
                "library_err_vs_fp32": _err(lib(), ref),
                "auto_impl": "kernel", "timing": how})
            print(json.dumps(results[-1]), flush=True)
    return results


# ---------------------------------------------------------------- softmax
def validate_softmax(smoke=False, device=None, iters=10,
                     shapes=((32, 1024, 1024), (8, 2048, 2048)),
                     dtypes=(torch.bfloat16, torch.float32)) -> List[Dict]:
    from apex_tpu_torch.ops.softmax import (
        scaled_softmax,
        scaled_upper_triang_masked_softmax,
    )

    device = device or torch.device("cuda", torch.cuda.current_device())
    cases = [(name, fn, shape) for shape in shapes for name, fn in (
        ("scaled_softmax", scaled_softmax),
        ("scaled_upper_triang_masked_softmax",
         scaled_upper_triang_masked_softmax))]
    if smoke:
        cases, dtypes = cases[:2], dtypes[:1]
    results = []
    for name, fn, shape in cases:
        for dtype in dtypes:
            x = _randn(shape, dtype, device, 2)
            xs = x.float() * 1.3
            if "triang" in name:
                xs = xs.masked_fill(torch.ones(
                    shape[-2:], dtype=torch.bool, device=device).triu(1),
                    float("-inf"))
            ref = torch.softmax(xs, -1)
            pre = xs.to(dtype)
            k_ms, how = device_ms(lambda: fn(x, 1.3), iters)
            l_ms, _ = device_ms(lambda: torch.softmax(pre, -1), iters)
            results.append({
                "kernel": name, "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "kernel_ms": round(k_ms, 4), "library_ms": round(l_ms, 4),
                "speedup": round(l_ms / k_ms, 3),
                "max_err_vs_fp32": _err(fn(x, 1.3), ref),
                "library_err_vs_fp32": _err(torch.softmax(pre, -1), ref),
                "auto_impl": "kernel", "timing": how})
            print(json.dumps(results[-1]), flush=True)
    return results


# ------------------------------------------------------------ dense / MLP
def validate_fused_dense(smoke=False, device=None, iters=10,
                         sizes=(8192, 1024, 4096),
                         dtypes=(torch.bfloat16, torch.float32)
                         ) -> List[Dict]:
    """The dense layers and the MLP (products and epilogues in PyTorch:
    no kernel of the port's) beside ``F.linear`` (+ ``F.gelu``)."""
    from apex_tpu_torch.fused_dense import (
        fused_dense_function,
        fused_dense_gelu_dense_function,
    )
    from apex_tpu_torch.mlp import MLP

    device = device or torch.device("cuda", torch.cuda.current_device())
    rows, hidden, ffn = (2048, 512, 2048) if smoke else sizes
    dtypes = dtypes[:1] if smoke else dtypes
    w1 = _randn((hidden, ffn), torch.float32, device, 3) * 0.02
    b1 = torch.zeros(ffn, device=device)
    w2 = _randn((ffn, hidden), torch.float32, device, 4) * 0.02
    b2 = torch.zeros(hidden, device=device)
    mlp = MLP([hidden, ffn, hidden], activation="relu", device=device)
    results = []
    for dtype in dtypes:
        x = _randn((rows, hidden), dtype, device, 5)
        m = MLP([hidden, ffn, hidden], activation="relu",
                params_dtype=dtype, device=device)
        m.load_state_dict({k: v.to(dtype) for k, v in mlp.state_dict().items()})

        def lib_dense(x_):
            return F.linear(x_, w1.T.to(x_.dtype), b1.to(x_.dtype))

        def lib_gelu(x_):
            h = F.gelu(lib_dense(x_), approximate="tanh")
            return F.linear(h, w2.T.to(x_.dtype), b2.to(x_.dtype))

        def lib_mlp(x_):
            layers = list(m.children())
            for i, layer in enumerate(layers):
                x_ = F.linear(x_, layer.weight.T.to(x_.dtype),
                              layer.bias.to(x_.dtype))
                if i < len(layers) - 1:
                    x_ = F.relu(x_)
            return x_

        cases = (("fused_dense", lambda x_: fused_dense_function(x_, w1, b1),
                  lib_dense),
                 ("fused_dense_gelu_dense",
                  lambda x_: fused_dense_gelu_dense_function(
                      x_, w1, b1, w2, b2), lib_gelu),
                 ("mlp", m, lib_mlp))
        for name, fused, lib in cases:
            with torch.no_grad():
                ref = lib(x.float())
                k_ms, how = device_ms(lambda: fused(x), iters)
                l_ms, _ = device_ms(lambda: lib(x), iters)
                results.append({
                    "kernel": name, "shape": [rows, hidden, ffn],
                    "dtype": str(dtype).replace("torch.", ""),
                    "kernel_ms": round(k_ms, 4),
                    "library_ms": round(l_ms, 4),
                    "speedup": round(l_ms / k_ms, 3),
                    "max_err_vs_fp32": _err(fused(x), ref),
                    "library_err_vs_fp32": _err(lib(x), ref),
                    "auto_impl": "kernel", "timing": how,
                    "note": "plain PyTorch in the port (no kernel)"})
            print(json.dumps(results[-1]), flush=True)
    return results


# ----------------------------------------------------------- optimizer tail
def validate_opt_tail(smoke=False, device=None, iters=10,
                      sizes=(8, 1024)) -> List[Dict]:
    """``FusedAdam`` with fp32 masters (one ``multi_tensor_adam`` launch)
    over the JAX tool's parameter set, its updated masters held against
    the same step on CPU copies (the plain version, bit for bit), timed
    beside ``torch._fused_adamw_`` on fp32 copies without masters."""
    from apex_tpu_torch.optimizers import FusedAdam

    device = device or torch.device("cuda", torch.cuda.current_device())
    layers, hidden = (2, 512) if smoke else sizes
    shapes = [(8192, hidden)] + [s for _ in range(layers) for s in (
        (hidden, 3 * hidden), (hidden, 4 * hidden), (hidden,))]
    params = [(_randn(s, torch.float32, device, i) * 0.02).to(torch.bfloat16)
              for i, s in enumerate(shapes)]
    grads = [(_randn(s, torch.float32, device, 100 + i) * 0.01).to(
        torch.bfloat16) for i, s in enumerate(shapes)]

    def make(dev):
        ps = [torch.nn.Parameter(p.detach().to(dev).clone()) for p in params]
        opt = FusedAdam(ps, lr=1e-3, master_weights=True)
        for p, g in zip(ps, grads):
            p.grad = g.to(dev)
        return ps, opt

    ps, opt = make(device)
    cpu_ps, cpu_opt = make("cpu")
    opt.step()
    cpu_opt.step()
    err = max(_err(opt.state[p]["master"].cpu(), cpu_opt.state[c]["master"])
              for p, c in zip(ps, cpu_ps))
    k_ms, how = device_ms(lambda: opt.step(), iters)
    fp = [p.detach().float().clone() for p in params]
    fg = [g.float() for g in grads]
    m1 = [torch.zeros_like(p) for p in fp]
    m2 = [torch.zeros_like(p) for p in fp]
    steps = [torch.zeros((), device=device) for _ in fp]
    l_ms = None
    if device.type == "cuda":
        l_ms, _ = device_ms(lambda: torch._fused_adamw_(
            fp, fg, m1, m2, [], steps, lr=1e-3, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False),
            iters)
    n = sum(p.numel() for p in params)
    nbytes = n * (2 + 2 + 8 + 8 + 8)
    rec = {"kernel": "opt_tail", "shape": [layers, hidden, n],
           "dtype": "bfloat16", "clip": False,
           "kernel_ms": round(k_ms, 4),
           "library_ms": None if l_ms is None else round(l_ms, 4),
           "speedup": None if l_ms is None else round(l_ms / k_ms, 3),
           "max_err_vs_fp32": err,
           "library_err_vs_fp32": 0.0, "traffic_bytes": nbytes,
           "achieved_gbs": round(nbytes / (k_ms * 1e-3) / 1e9, 1),
           "auto_impl": "kernel", "timing": how,
           "note": "max_err: the card's masters against the plain "
                   "version's on CPU copies (the same bits expected)"}
    print(json.dumps(rec), flush=True)
    return [rec]


# ----------------------------------------------------------------- decode
def _paged_ref(q, kp, vp, table, lengths, ks=None, vs=None, kv_block=128,
               bp=None):
    """fp32 ground truth of the first ``bp`` sequences: each one's pages
    gathered and dequantized, causal over its last ``sq`` positions."""
    from apex_tpu_torch.ops.quantization import dequantize_rows

    b, h, sq, d = q.shape
    bp = b if bp is None else min(b, bp)
    outs = []
    for i in range(bp):
        n = int(lengths[i])
        pages = table[i]

        def gather(p, sc):
            x = p[pages]                               # (npp, h, ps, d)
            if sc is not None:
                x = dequantize_rows(x.reshape(-1, d), sc[pages].reshape(
                    -1, sc.shape[-1]), kv_block).reshape(x.shape)
            return x.float().permute(1, 0, 2, 3).reshape(h, -1, d)[:, :n]

        kk, vv = gather(kp, ks), gather(vp, vs)
        s = torch.matmul(q[i].float(), kk.transpose(-1, -2)) / math.sqrt(d)
        pos = n - sq + torch.arange(sq, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(n, device=q.device)[None] > pos,
                          float("-inf"))
        outs.append(torch.matmul(torch.softmax(s, -1), vv))
    return torch.stack(outs)


def _decode_case(b, cache, sq, kv, device, seed, iters, h=4, d=128, ps=64):
    from apex_tpu_torch.ops.attention_decode import fmha_decode
    from apex_tpu_torch.ops.quantization import quantize_rows

    npp = cache // ps
    pool_pages = 1 + b * npp
    km = _randn((pool_pages, h, ps, d), torch.bfloat16, device, seed)
    vm = _randn((pool_pages, h, ps, d), torch.bfloat16, device, seed + 1)
    q = _randn((b, h, sq, d), torch.bfloat16, device, seed + 2)
    g = torch.Generator(device="cpu").manual_seed(seed + 3)
    perm = 1 + torch.randperm(pool_pages - 1, generator=g)
    table = perm[:b * npp].reshape(b, npp).to(torch.int32).to(device)
    lengths = torch.tensor([cache if i % 2 == 0 else cache - ps // 2 - 1
                            for i in range(b)], dtype=torch.int32,
                           device=device)
    ks = vs = None
    if kv == "int8":
        def q8(pages):
            vals, sc = quantize_rows(pages.reshape(-1, d).float(), 128)
            return vals.reshape(pages.shape), sc.reshape(*pages.shape[:-1],
                                                         -1)
        kp, ks = q8(km)
        vp, vs = q8(vm)
        q = q.to(torch.bfloat16)
    else:
        dt = getattr(torch, kv)
        kp, vp = km.to(dt), vm.to(dt)
        q = q.to(dt)
    run = lambda: fmha_decode(q, kp, vp, table, lengths, causal=True,
                              k_scales=ks, v_scales=vs)
    bp = min(b, 32)
    ref = _paged_ref(q, kp, vp, table, lengths, ks, vs, bp=bp)
    out = run()[:bp]
    # the plain version on the card: the yardstick of the error (the
    # same math, rounded to the output's dtype)
    from apex_tpu_torch.ops.attention_decode import _decode_plain

    plain = _decode_plain(q[:bp], kp, vp, table[:bp], lengths[:bp], True,
                          1.0 / math.sqrt(d), None, ks, vs, 128)
    k_ms, how = device_ms(run, iters)
    kv_bytes = 2 * int(lengths.sum()) * h * (
        d * kp.element_size() + (4 if ks is not None else 0))
    return {
        "kernel": "fmha_decode", "shape": [b, h, sq, d], "cache_len": cache,
        "page_size": ps, "dtype": kv, "causal": True, "auto_impl": "kernel",
        "fwd": {"kernel_ms": round(k_ms, 4), "library_ms": None,
                "decode_gbs": round(kv_bytes / (k_ms * 1e-3) / 1e9, 1),
                "max_err_vs_fp32": _err(out, ref),
                "library_err_vs_fp32": _err(plain, ref)},
        "timing": how,
        "note": "no PyTorch call takes the paged layout; the error "
                "yardstick is the plain version's on the card"}


def validate_fmha_decode(smoke=False, device=None, iters=10,
                         batches=(1, 8, 64, 256), caches=(512, 2048, 8192),
                         kvs=("bfloat16", "float32", "int8"),
                         sqs=(64, 256), sq_kvs=("bfloat16", "int8"),
                         sq_cache: int = 2048) -> List[Dict]:
    """The decode grid (batch x cache length x KV dtype, q at s=1) and the
    chunked-prefill cells (s_q 64 and 256 over a 2048-token cache), ragged
    lengths over shuffled page tables, as the JAX tool's; then the
    generation identities.  The JAX tool's head-sharded (tp) cells are
    multi-GPU (ROADMAP queue A item 9)."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    if smoke:
        batches, caches, kvs = [8], [512], ["bfloat16", "int8"]
        sqs, sq_kvs, sq_cache = [64], ["bfloat16"], 512
    results = []
    for b in batches:
        for cache in caches:
            for kv in kvs:
                results.append(_decode_case(b, cache, 1, kv, device, b,
                                            iters))
                print(json.dumps(results[-1]), flush=True)
                torch.cuda.empty_cache()
    for sq in sqs:
        for kv in sq_kvs:
            results.append(_decode_case(8, sq_cache, sq, kv, device, sq,
                                        iters))
            print(json.dumps(results[-1]), flush=True)
    results.append(validate_generation(device))
    print(json.dumps(results[-1]), flush=True)
    return results


def validate_generation(device) -> Dict:
    """Gate (6)'s identities: greedy generation through the paged serving
    stack (monolithic; chunked with the prefix cache; speculative k=4)
    equals the full-recompute reference, at fp32."""
    from apex_tpu_torch.models import GPTConfig, GPTModel

    model = GPTModel(GPTConfig(
        vocab_size=512, num_layers=2, hidden_size=512,
        num_attention_heads=4, max_position_embeddings=64,
        compute_dtype=torch.float32), device=device, seed=0)
    bgen, sp, new = 4, 16, 32
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, 512, (bgen, sp)).astype(np.int32)
    plens = np.array([sp, sp - 3, sp - 7, 5], np.int32)
    for i in range(bgen):
        prompts[i, plens[i]:] = 0
    ref = model.generate_reference(prompts, plens, new)
    kw = dict(page_size=16, max_seqs=2, harvest_every=4)
    got = model.generate(prompts, plens, new, **kw)
    got_c = model.generate(prompts, plens, new, prefill_chunk=8,
                           prefix_cache=True, **kw)
    got_s = model.generate(prompts, plens, new, speculate_k=4, **kw)
    same = lambda g: all(list(ref[i]) == list(g[i]) for i in range(bgen))
    return {"kernel": "decode_generation", "shape": [bgen, sp, new],
            "dtype": "float32", "greedy_match": bool(same(got)),
            "chunked_greedy_match": bool(same(got_c)),
            "speculative_greedy_match": bool(same(got_s)),
            "note": "paged serving stack (2 slots / 4 requests; monolithic, "
                    "chunked + prefix cache, speculative k=4) vs the "
                    "full-recompute greedy reference"}


# ----------------------------------------------------------------- dequant
def validate_dequant_matmul(smoke=False, device=None, iters=10,
                            ms=(1, 8, 64),
                            shapes=(("qkv", 2048, 6144),
                                    ("ffn_up", 2048, 8192),
                                    ("ffn_down", 8192, 2048))
                            ) -> List[Dict]:
    """Rows m in {1, 8, 64} x the three projections a decode layer streams
    at h=2048 x {int8, int4}, against the fp32 product with the
    dequantized matrix; beside it the dense ``torch.matmul`` of the wide
    weights in x's dtype (a separate reading: it reads 2-4x the
    bytes)."""
    from apex_tpu_torch.ops.dequant_matmul import (
        dequant_matmul,
        dequantize_weight,
        quantize_weight,
    )

    device = device or torch.device("cuda", torch.cuda.current_device())
    block = 128
    if smoke:
        ms, shapes = [8], [("qkv", 512, 1536)]
    results = []
    for i, (name, k, n) in enumerate(shapes):
        w = _randn((k, n), torch.float32, device, 10 + i)
        for wd in ("int8", "int4"):
            wq = quantize_weight(w, wd, block)
            qv = wq["q8"] if wd == "int8" else wq["q4"]
            wref = dequantize_weight(wq)
            dense = wref.to(torch.bfloat16)
            for m in ms:
                x = _randn((m, k), torch.bfloat16, device, 20 + m)
                ref = x.float() @ wref
                run = lambda: dequant_matmul(x, qv, wq["scales"],
                                             weight_dtype=wd)
                k_ms, how = device_ms(run, iters)
                d_ms, _ = device_ms(lambda: torch.matmul(x, dense), iters)
                w_bytes = qv.numel() + wq["scales"].numel() * 4
                results.append({
                    "kernel": "dequant_matmul", "proj": name,
                    "shape": [m, k, n], "dtype": wd, "x_dtype": "bfloat16",
                    "block_size": block, "auto_impl": "kernel",
                    "fwd": {"kernel_ms": round(k_ms, 4),
                            "dense_matmul_ms": round(d_ms, 4),
                            "weight_gbs": round(
                                w_bytes / (k_ms * 1e-3) / 1e9, 1),
                            "max_err_vs_fp32": _err(run(), ref),
                            "library_err_vs_fp32": _err(
                                torch.matmul(x, dense), ref)},
                    "timing": how})
                print(json.dumps(results[-1]), flush=True)
    return results


# ------------------------------------------------------------------- gates
def gates(entries: List[Dict]) -> Tuple[List[str], List[str]]:
    """``(failures, findings)``.  Failures: the numeric gate (1) and the
    identity gate (6).  Findings: the speed gate (2) as kernel against
    library, and the crossover gates (3), (3b) and (5) from the card's
    numbers."""
    bad, found = [], []
    for e in entries:
        tag = f"{e['kernel']} {e.get('rung', '')} {e['shape']} {e['dtype']}"
        f = e.get("fwd", e)
        err = f.get("max_err_vs_fp32")
        if err is not None:
            ref_err = max(f.get("library_err_vs_fp32") or 0.0,
                          NUMERIC_FLOOR)
            if not math.isfinite(err) or err > NUMERIC_FACTOR * ref_err:
                bad.append(f"{tag}: fwd err {err:.3g} > {NUMERIC_FACTOR:g}x "
                           f"the library's {ref_err:.3g}")
        g = e.get("fwd_bwd", {}).get("grad_max_rel_err")
        if g is not None and not g <= GRAD_REL_LIMIT:
            bad.append(f"{tag}: grad rel err {g:.3g} > {GRAD_REL_LIMIT}")
        if e["kernel"] == "decode_generation":
            for key in ("greedy_match", "chunked_greedy_match",
                        "speculative_greedy_match"):
                if not e.get(key, True):
                    bad.append(f"{tag}: {key} failed: the paged stack "
                               "diverged from the full-recompute reference")
        for part in ("fwd", "fwd_bwd"):
            p = e.get(part, e if part == "fwd" else {})
            sp = p.get("speedup")
            if sp is not None and sp < 1.0 and e.get("rung", "auto") in (
                    "auto", e.get("auto_impl")):
                found.append(f"(2) {tag} {part}: the kernel is "
                             f"{1 / sp:.2f}x its library call")
    x = crossovers(entries)
    for key, case in x["by_case"].items():
        for part, fastest in case["fastest"].items():
            for s, rung in fastest.items():
                auto = _auto_rung(s)
                if rung != auto:
                    gate = "(3)" if auto == "short" or rung == "short" \
                        else "(3b)"
                    found.append(f"{gate} {key} s={s} {part}: the ladder "
                                 f"picks {auto}, {rung} is faster")
    flag = {}
    for e in entries:
        if e["kernel"] == "fmha_mid" and e["shape"][2] == 1024 \
                and e["dtype"] == "bfloat16":
            flag[e["causal"]] = e["fwd"]["kernel_ms"]
    if True in flag and False in flag and flag[True] / flag[False] > 0.7:
        found.append(f"(5) mid s=1024 bf16: causal / full {flag[True] / flag[False]:.2f} > 0.7")
    return bad, found


def run(smoke: bool = False, device=None) -> Dict:
    """Every validation in one process: the document (JAX's top-level
    keys, the card's name and the findings beside them)."""
    from apex_tpu_torch.ops.attention_mid import mid_seq_threshold
    from apex_tpu_torch.ops.attention_short import short_seq_threshold

    t0 = time.time()
    iters = 5 if smoke else 10
    entries = []
    entries += validate_attention(smoke, device=device, iters=iters)
    entries += validate_layer_norm(smoke, device, iters)
    entries += validate_softmax(smoke, device, iters)
    entries += validate_fused_dense(smoke, device, iters)
    entries += validate_opt_tail(smoke, device, iters)
    entries += validate_fmha_decode(smoke, device, iters)
    entries += validate_dequant_matmul(smoke, device, iters)
    bad, found = gates(entries)
    return {
        "device": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                   else "cpu"),
        "torch_version": torch.__version__,
        "smoke": bool(smoke),
        "wall_s": round(time.time() - t0, 1),
        "fmha_short_max_seq": short_seq_threshold(),
        "fmha_mid_max_seq": mid_seq_threshold(),
        "crossovers": crossovers(entries),
        "failures": bad,
        "findings": found,
        "entries": entries,
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one shape per kernel")
    ap.add_argument("--strict", action="store_true",
                    help="the findings (gates 2, 3, 3b, 5) fail the run too")
    ap.add_argument("--out", default=os.path.join(
        _REPO, "tool_out", "kernel_validation.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel validation runs on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    doc = run(args.smoke)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out} ({len(doc['entries'])} entries, "
          f"{doc['wall_s']}s)")
    for why in doc["findings"]:
        print(f"FINDING: {why}")
    for why in doc["failures"]:
        print(f"GATE FAIL: {why}")
    if doc["failures"] or (args.strict and doc["findings"]):
        raise SystemExit(1)
    return doc


if __name__ == "__main__":
    main()
