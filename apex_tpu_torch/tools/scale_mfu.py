"""MFU against hidden size on one GPU.

The port's twin of the root ``tools/scale_mfu.py``: the flagship train
step of :mod:`apex_tpu_torch.tools.profile_r05` (O5, remat, ``FusedAdam``
with fp32 masters, the attention ladder, the automatic cross entropy),
only the width scaled, over the JAX tool's three configurations.  MFU is
the model FLOPs of ``telemetry.metrics.transformer_flops_per_token``
(``6 N + 12 L h s``) a second over the card's dense bf16 peak by its name
(``device_peak_flops``: 989 TFLOP/s for an H100).

Writes JSON to ``--out`` (default under the git-ignored
``tool_out/``).  Needs a CUDA device::

    python -m apex_tpu_torch.tools.scale_mfu --out tool_out/scale_mfu.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from apex_tpu_torch.tools import profile_r05

_REPO = profile_r05._REPO
SEQ = 1024
WARMUP, STEPS = 2, 10

#: (tag, layers, hidden, heads, batch): the JAX tool's configurations
CONFIGS = [
    ("flagship_h1024", 12, 1024, 8, 8),
    ("h1536", 12, 1536, 12, 8),
    ("h2048", 12, 2048, 16, 8),
]


def measure(tag, layers, hidden, heads, batch, device=None) -> Dict:
    """One configuration's row: ms/step, tokens/s and MFU."""
    from apex_tpu_torch.telemetry.metrics import (
        device_peak_flops,
        transformer_flops_per_token,
    )

    model, opt, step, n_params = profile_r05.build(
        device, num_layers=layers, hidden_size=hidden,
        num_attention_heads=heads)
    tokens, targets = profile_r05.batch(model.device, batch, SEQ)
    torch.cuda.reset_peak_memory_stats(model.device)
    for _ in range(WARMUP):
        step(tokens, targets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        loss = step(tokens, targets)
    final = float(loss)
    dt = (time.perf_counter() - t0) / STEPS
    if not np.isfinite(final):
        raise FloatingPointError(f"{tag}: non-finite loss {final}")
    flops_per_token = transformer_flops_per_token(n_params, layers, hidden,
                                                  SEQ)
    tok_s = batch * SEQ / dt
    peak = device_peak_flops(model.device)
    row = {
        "tag": tag, "layers": layers, "hidden": hidden, "heads": heads,
        "batch": batch, "seq": SEQ, "n_params": n_params,
        "ms_per_step": round(dt * 1e3, 2),
        "tokens_per_sec": round(tok_s, 1),
        "mfu": round(tok_s * flops_per_token / peak, 4) if peak else None,
        "peak_gib": round(torch.cuda.max_memory_allocated(model.device)
                          / 2 ** 30, 2),
    }
    print(json.dumps(row), flush=True)
    del model, opt, step
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        _REPO, "tool_out", "scale_mfu.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scale_mfu runs on a CUDA device")
    rows = []
    for cfg in CONFIGS:
        try:
            rows.append(measure(*cfg))
        except torch.cuda.OutOfMemoryError as e:
            # an OOM at the largest configuration is a finding; the rows
            # measured stay
            rows.append({"tag": cfg[0], "error": str(e)[:300]})
            print(f"{cfg[0]}: FAILED ({str(e)[:160]})", flush=True)
    doc = {
        "device_kind": torch.cuda.get_device_name(0),
        "note": "the flagship train step of tools/profile_r05.py (O5), "
                "the hidden size scaled",
        "rows": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")
    return doc


if __name__ == "__main__":
    main()
