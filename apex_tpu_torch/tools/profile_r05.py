"""Step-time decomposition of the flagship GPT train step on one GPU.

The port's twin of the root ``tools/profile_r05.py``: the same variants
of the flagship step (bench.py's FLAGSHIP: vocab 32768, 12 layers,
hidden 1024, 8 heads, 8 x 1024 tokens; O5: bf16 parameters and compute,
fp32 norms and masters, ``FusedAdam``, remat, the attention ladder, the
automatic cross entropy), each timed in one process (2 warm-up steps,
then 10 steps on the host clock closed by a synchronize), and beside
each its ``apex_tpu_torch.pyprof`` class table from a profiled step.

Two JAX variants have no program of their own here and stay rows with
the reason: ``attention xla`` (``attention_impl="xla"`` raises in the
port: the plain attention is the CPU path and the oracle, never a path
on the card) and ``remat dots_saveable`` (the port accepts
``remat_policy`` and saves only each layer's input whatever it says,
``models/gpt.py``'s ``GPTConfig``; the row runs the headline's program).

Writes JSON to ``--out`` and a markdown table beside it (same stem,
``.md``); the default is under the git-ignored ``tool_out/``.  Needs
a CUDA device::

    python -m apex_tpu_torch.tools.profile_r05 --out tool_out/profile_r05.json
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the flagship's shape, the port's copy of bench.py's FLAGSHIP
FLAGSHIP = dict(vocab_size=32768, num_layers=12, hidden_size=1024,
                num_attention_heads=8, seq=1024, batch=8)
WARMUP, STEPS = 2, 10
#: profiler sessions to open before giving up on device records (CUPTI
#: can hand a session none)
PROFILE_TRIES = 3

#: (label, GPTConfig overrides or a step variant); the JAX tool's list
VARIANTS = (
    ("fused_ce scan chunk=8192", {"fused_ce": True}),
    ("fused_ce scan chunk=16384", {"fused_ce": True,
                                   "fused_ce_chunk": 16384}),
    ("fused_ce scan chunk=32768", {"fused_ce": True,
                                   "fused_ce_chunk": 32768}),
    ("attention xla", {"attention_impl": "xla"}),
    ("remat off", {"remat": False}),
    ("remat dots_saveable", {"remat_policy": "dots_saveable"}),
    ("fwd only", {"_fwd_only": True}),
    ("fwd+bwd, no optimizer", {"_no_opt": True}),
    ("optimizer tail only", {"_opt_only": True}),
)
HEADLINE = "headline (bf16+remat+autoCE)"

#: rows the port has no program for, with the reason
NOT_RUN = {
    "attention xla": "attention_impl='xla' raises NotImplementedError in "
                     "the port: the plain "
                     "attention is the CPU path and the kernels' oracle, "
                     "not a path on the GPU (ROADMAP queue C)",
}
#: rows that run another row's program, with the reason
SAME_PROGRAM = {
    "remat dots_saveable": "remat_policy is accepted and does not change "
                           "what the port saves (each layer's input, "
                           "models/gpt.py GPTConfig): the headline's "
                           "program",
}


def make_step(model, opt, *, fwd_only=False, opt_only=False, no_opt=False):
    """The train step of one variant: ``step(tokens, targets) -> loss``
    (a device scalar, no host synchronisation).

    ``fwd_only``: the loss alone, no gradients.  ``no_opt``: forward and
    backward, the optimizer left out; a zero sum of the gradients rides
    the loss so they are a data dependency, as in JAX.
    ``opt_only``: the forward and the optimizer tail over zero gradients
    of the parameters' dtypes (JAX's ``p * 0``, with the backward left
    out), so the tail reads the bytes the full step's does."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(tokens, targets):
        if fwd_only:
            with torch.no_grad():
                return model.loss(tokens, targets)
        opt.zero_grad(set_to_none=True)
        if opt_only:
            with torch.no_grad():
                loss = model.loss(tokens, targets)
                for p in params:
                    p.grad = p * 0
            opt.step()
            return loss
        loss = model.loss(tokens, targets)
        loss.backward()
        if no_opt:
            gsum = sum((p.grad.float() * 0).sum() for p in params)
            return loss.detach() + gsum
        opt.step()
        return loss.detach()

    return step


def build(device=None, *, seed: int = 0, **cfg_over):
    """``(model, opt, step, n_params)`` of one variant at the flagship
    shape (``cfg_over`` overrides GPTConfig fields, ``_fwd_only`` /
    ``_no_opt`` / ``_opt_only`` pick the step): O5 (bf16 parameters and
    compute, fp32 norms), remat on, ``FusedAdam(lr=1e-4)`` with fp32
    masters."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam

    cfg_over = dict(cfg_over)
    kinds = {k: cfg_over.pop(k, False)
             for k in ("_fwd_only", "_no_opt", "_opt_only")}
    cfg = dict(vocab_size=FLAGSHIP["vocab_size"],
               num_layers=FLAGSHIP["num_layers"],
               hidden_size=FLAGSHIP["hidden_size"],
               num_attention_heads=FLAGSHIP["num_attention_heads"],
               max_position_embeddings=FLAGSHIP["seq"],
               policy=get_policy("O5"), remat=True)
    cfg.update(cfg_over)
    model = GPTModel(GPTConfig(**cfg), device=device, seed=seed)
    policy = cfg["policy"]
    opt = FusedAdam(model.parameters(), lr=1e-4,
                    master_weights=policy.master_weights)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_step(model, opt, fwd_only=kinds["_fwd_only"],
                     opt_only=kinds["_opt_only"], no_opt=kinds["_no_opt"])
    return model, opt, step, n_params


def batch(device, b: int = None, s: int = None, vocab: int = None,
          seed: int = 1):
    """A seeded token batch and its targets (the tokens shifted left)."""
    b = FLAGSHIP["batch"] if b is None else b
    s = FLAGSHIP["seq"] if s is None else s
    vocab = FLAGSHIP["vocab_size"] if vocab is None else vocab
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    toks = torch.from_numpy(toks.astype(np.int64)).to(device)
    return toks, torch.roll(toks, -1, dims=1)


def class_table(step, tokens, targets) -> Optional[List[Dict]]:
    """The device's per-class split of one profiled step (``pyprof``),
    or None when no profiler session got device records."""
    from apex_tpu_torch import pyprof

    for _ in range(PROFILE_TRIES):
        with tempfile.TemporaryDirectory() as d:
            with pyprof.trace(d):
                step(tokens, targets)
            rows = pyprof.parse(d, plane_filter="GPU")
        if rows:
            return pyprof.prof(rows)
    return None


def measure(label: str, device=None, **cfg_over) -> Dict:
    """Time one variant: ``{"label", "ms_per_step", "n_params",
    "final_loss", "classes"}``."""
    from apex_tpu_torch import pyprof

    model, opt, step, n_params = build(device, **cfg_over)
    tokens, targets = batch(model.device)
    for _ in range(WARMUP):
        step(tokens, targets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        loss = step(tokens, targets)
    final = float(loss)
    dt = (time.perf_counter() - t0) / STEPS
    if not np.isfinite(final):
        raise FloatingPointError(f"{label}: non-finite loss {final}")
    print(f"{label:28s} {dt * 1e3:8.2f} ms/step", flush=True)
    classes = class_table(step, tokens, targets)
    row = {"label": label, "ms_per_step": round(dt * 1e3, 2),
           "n_params": n_params, "final_loss": final,
           "classes": None if classes is None else [
               {k: c[k] for k in ("op_class", "kind", "count", "total_ms",
                                  "pct")} for c in classes]}
    print(pyprof.prof_table(classes) if classes else
          "  device classes not measured: no profiler session got device "
          "records", flush=True)
    del model, opt, step
    torch.cuda.empty_cache()
    return row


def run(labels=None, device=None) -> Dict:
    """The decomposition: the headline, then each variant of
    :data:`VARIANTS` (``labels`` picks some), in one process."""
    from apex_tpu_torch.telemetry.metrics import (
        device_peak_flops,
        transformer_flops_per_token,
    )

    rows = [measure(HEADLINE, device)]
    n_params = rows[0]["n_params"]
    for label, kw in VARIANTS:
        if labels is not None and label not in labels:
            continue
        if label in NOT_RUN:
            rows.append({"label": label, "ms_per_step": None,
                         "note": NOT_RUN[label]})
            print(f"{label:28s} not run: {NOT_RUN[label]}", flush=True)
            continue
        try:
            row = measure(label, device, **kw)
        except (RuntimeError, ValueError, FloatingPointError) as e:
            # a broken variant (an OOM with remat off, say) is a finding
            # to record; the rows already measured stay
            print(f"{label}: FAILED ({str(e)[:160]})", flush=True)
            row = {"label": label, "ms_per_step": None,
                   "error": str(e)[:300]}
        if label in SAME_PROGRAM:
            row["note"] = SAME_PROGRAM[label]
        rows.append(row)
    head_ms = rows[0]["ms_per_step"]
    flops_per_token = transformer_flops_per_token(
        n_params, FLAGSHIP["num_layers"], FLAGSHIP["hidden_size"],
        FLAGSHIP["seq"])
    tok_s = FLAGSHIP["batch"] * FLAGSHIP["seq"] / (head_ms / 1e3)
    peak = device_peak_flops()
    return {
        "config": dict(FLAGSHIP, opt_level="O5",
                       device_kind=torch.cuda.get_device_name(0)),
        "rows": rows,
        "tokens_per_sec": round(tok_s, 1),
        "mfu": round(tok_s * flops_per_token / peak, 4) if peak else None,
        "peak_flops": peak,
    }


def markdown(doc: Dict) -> str:
    rows = doc["rows"]
    head = rows[0]["ms_per_step"]
    c = doc["config"]
    lines = [
        "# profile_r05: step-time decomposition (flagship GPT, 1 GPU)", "",
        f"Config: {c['num_layers']}L / h{c['hidden_size']} / b{c['batch']} "
        f"/ s{c['seq']} / vocab {c['vocab_size']}, O5 (bf16, fp32 norms "
        f"and masters), device `{c['device_kind']}`.",
        f"Headline: **{head:.2f} ms/step, {doc['tokens_per_sec']:,.0f} "
        f"tokens/s" + (f", MFU {doc['mfu']:.4f}**" if doc["mfu"] else "**"),
        "", "| variant | ms/step | delta vs headline | note |",
        "|---|---|---|---|",
    ]
    for r in rows:
        note = r.get("note") or r.get("error") or ""
        if r["ms_per_step"] is None:
            lines.append(f"| {r['label']} | — | — | {note} |")
            continue
        lines.append(f"| {r['label']} | {r['ms_per_step']:.2f} | "
                     f"{r['ms_per_step'] - head:+.2f} | {note} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        _REPO, "tool_out", "profile_r05.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_r05 runs on a CUDA device")
    doc = run()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    with open(os.path.splitext(args.out)[0] + ".md", "w") as f:
        f.write(markdown(doc))
    print(json.dumps({"mfu": doc["mfu"],
                      "tokens_per_sec": doc["tokens_per_sec"]}))
    return doc


if __name__ == "__main__":
    main()
