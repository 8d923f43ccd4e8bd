"""Device memory audit on one GPU: what the serving pools of each model
tier take at each weight width, and what the flagship train step holds.

The one-GPU part of the root ``tools/memory_audit.py``:

- ``--serve`` (``run_serve_audit``): for each tier of JAX's
  :data:`SERVE_TIERS` and each weight width (fp32, bf16, int8, int4) the
  weight pool's bytes, the KV pool's (int8 pages, fp32 beside them), a
  structural estimate of the decode activations, the verdict against the
  card's memory, the draft model's co-residency (the 1B tier's int4 pool
  and its own int8 KV pages), and the largest tier that fits.  The pools
  are priced from the port's own pool functions (``quantize_gpt_weights``, the
  serving bf16 copies, ``init_pools``) run on fake tensors
  (``FakeTensorMode``: shapes and dtypes, no memory), so a 70B tier
  prices in seconds.  ``materialize_serve_pools`` builds the 1B tier's
  int8 weight pool and int8 KV pool on the card to check the pricing
  against ``torch.cuda.memory_allocated``.
- the train step (``run_train_audit``): its argument bytes (parameters,
  fp32 masters, both moments, the step counter, the token batch) counted
  exactly from the port's tensors, and one flagship step's
  ``torch.cuda.max_memory_allocated`` in place of XLA's buffer
  assignment (``temp``/``peak``).

The memory limit is the card's ``total_memory`` (``--hbm-gb`` overrides
it, and is needed without a card).  ``--compare`` and ``--train-steps``
(ZeRO-3 against replicated data parallelism) and tensor-parallel degrees
above 1 are multi-GPU and raise, naming ROADMAP queue A item 9.

    python -m apex_tpu_torch.tools.memory_audit --serve --out tool_out/memory_audit_serve.json
    python -m apex_tpu_torch.tools.memory_audit --out tool_out/memory_audit.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The serving tier ladder (head_dim 128, gelu MLP, rope): the JAX
#: tool's, copied
SERVE_TIERS = (
    ("1B", dict(vocab=32768, layers=20, hidden=2048, heads=16)),
    ("3B", dict(vocab=32768, layers=32, hidden=2560, heads=20)),
    ("8B", dict(vocab=32768, layers=32, hidden=4096, heads=32)),
    ("13B", dict(vocab=32768, layers=40, hidden=5120, heads=40)),
    ("30B", dict(vocab=32768, layers=44, hidden=6144, heads=48)),
    ("70B", dict(vocab=32768, layers=80, hidden=8192, heads=64)),
)
WEIGHT_WIDTHS = ("fp32", "bf16", "int8", "int4")
SERVE_TP_DEGREES = (1,)

_MULTI_GPU = ("is multi-GPU: ROADMAP queue A item 9 (A9); the port "
              "audits one GPU")


def card_memory_gb(device=None) -> float:
    """The card's memory in GB (1e9 bytes): the verdicts' limit."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    return torch.cuda.get_device_properties(dev).total_memory / 1e9


def module_bytes(module: torch.nn.Module) -> int:
    """Bytes of a module's distinct parameters and buffers (a tensor two
    modules share counts once)."""
    seen = {}
    for t in list(module.parameters()) + list(module.buffers()):
        seen[id(t)] = t.numel() * t.element_size()
    return sum(seen.values())


def _tier_model(shape: Dict, context: int):
    """The tier's fp32 GPT (rope, no position table), built from the
    port's constructor on fake tensors."""
    from apex_tpu_torch.models import GPTConfig, GPTModel

    return GPTModel(GPTConfig(
        vocab_size=shape["vocab"], num_layers=shape["layers"],
        hidden_size=shape["hidden"], num_attention_heads=shape["heads"],
        max_position_embeddings=context, position_embedding="rope",
        compute_dtype=torch.float32), device="cpu")


def serve_pool(model, width: str, block: int = 128):
    """The serving model at ``width``: the fp32 model itself, its bf16
    projection copies (``decode_fns(weight_dtype="bf16")``), or its int8 /
    int4 pools (``quantize_gpt_weights``)."""
    from apex_tpu_torch.models.gpt import (
        _bf16_projections,
        quantize_gpt_weights,
    )

    if width == "fp32":
        return model
    if width == "bf16":
        return _bf16_projections(model)
    return quantize_gpt_weights(model, width, block)


def kv_config(layers: int, heads: int, head_dim: int, *, max_seqs: int,
              context: int, page_size: int, kv_dtype):
    """The serving scenario's paged-KV config (one null page, then
    ``max_seqs`` sequences of ``context`` tokens)."""
    from apex_tpu_torch.serving.kv_cache import KVCacheConfig

    pages_per_seq = -(-context // page_size)
    return KVCacheConfig(
        num_layers=layers, num_heads=heads, head_dim=head_dim,
        num_pages=1 + max_seqs * pages_per_seq, page_size=page_size,
        max_seqs=max_seqs, pages_per_seq=pages_per_seq,
        dtype=torch.float32, kv_dtype=kv_dtype)


def _kv_pool_bytes(cfg, device="cpu") -> int:
    from apex_tpu_torch.serving.kv_cache import init_pools

    return sum(t.numel() * t.element_size()
               for t in init_pools(cfg, device).values())


def _check_tp(tp) -> Tuple[int, ...]:
    tp = tuple(int(t) for t in (tp or ()))
    if any(t != 1 for t in tp):
        raise NotImplementedError(f"tensor-parallel degrees {tp} {_MULTI_GPU}")
    return tp


def run_serve_audit(hbm_gb: Optional[float] = None, max_seqs: int = 4,
                    context: int = 1024, page_size: int = 64,
                    block: int = 128, tp=SERVE_TP_DEGREES,
                    draft_tier: Optional[str] = "1B") -> Dict:
    """The --serve document, JAX's keys: per tier and weight width the
    weight pool, the int8 KV pool and activations, the verdict under
    ``hbm_gb`` (the card's memory by default), the draft model's
    co-resident verdict, and the largest tier that fits at each width.
    ``tp`` may hold only 1 (its sub-rows equal the whole pool's)."""
    tp = _check_tp(tp)
    if hbm_gb is None:
        hbm_gb = card_memory_gb()
    hbm = hbm_gb * 1e9
    tiers = []
    largest_fit = {w: None for w in WEIGHT_WIDTHS}
    largest_fit_draft = {w: None for w in WEIGHT_WIDTHS}
    draft = None
    with FakeTensorMode():
        if draft_tier is not None:
            dshape = dict(SERVE_TIERS)[draft_tier]
            dmodel = _tier_model(dshape, context)
            draft = {
                "tier": draft_tier,
                "weight_width": "int4",
                "weight_pool_bytes": module_bytes(
                    serve_pool(dmodel, "int4", block)),
                "kv_pool_bytes": _kv_pool_bytes(kv_config(
                    dshape["layers"], dshape["heads"],
                    dshape["hidden"] // dshape["heads"], max_seqs=max_seqs,
                    context=context, page_size=page_size,
                    kv_dtype=torch.int8)),
            }
            draft["total_bytes"] = (draft["weight_pool_bytes"]
                                    + draft["kv_pool_bytes"])
        for name, shape in SERVE_TIERS:
            head_dim = shape["hidden"] // shape["heads"]
            model = _tier_model(shape, context)
            n_params = sum(p.numel() for p in model.parameters())
            kv = {
                "fp32": _kv_pool_bytes(kv_config(
                    shape["layers"], shape["heads"], head_dim,
                    max_seqs=max_seqs, context=context,
                    page_size=page_size, kv_dtype=None)),
                "int8": _kv_pool_bytes(kv_config(
                    shape["layers"], shape["heads"], head_dim,
                    max_seqs=max_seqs, context=context,
                    page_size=page_size, kv_dtype=torch.int8)),
            }
            act = int(max_seqs * (4 * shape["hidden"] * 4 * 4
                                  + shape["vocab"] * 4))
            row = {"tier": name, "shape": dict(shape),
                   "n_params": n_params, "kv_pool_bytes": kv,
                   "activations_bytes": act, "widths": {}}
            for w in WEIGHT_WIDTHS:
                wp = module_bytes(serve_pool(model, w, block))
                total = wp + kv["int8"] + act
                fits = total < hbm
                cell = {"weight_pool_bytes": wp, "total_bytes": total,
                        "fits_hbm": bool(fits)}
                if fits:
                    largest_fit[w] = name       # tiers ascend in size
                if draft is not None:
                    dtot = total + draft["total_bytes"]
                    cell["with_draft"] = {"total_bytes": dtot,
                                          "fits_hbm": bool(dtot < hbm)}
                    if dtot < hbm:
                        largest_fit_draft[w] = name
                if tp:
                    # one shard of tp=1 holds the whole pool
                    cell["tp"] = {"1": {
                        "per_shard_weight_pool_bytes": wp,
                        "per_shard_kv_pool_bytes": kv["int8"],
                        "per_shard_total_bytes": total,
                        "fits_hbm": bool(fits),
                        **({} if draft is None else {"with_draft": {
                            "per_shard_total_bytes": total
                            + draft["total_bytes"],
                            "fits_hbm": bool(total + draft["total_bytes"]
                                             < hbm)}})}}
                row["widths"][w] = cell
            tiers.append(row)
    only_tp = []
    for r in tiers:
        if any(r["widths"][w]["fits_hbm"] for w in WEIGHT_WIDTHS):
            continue
        fits_at = [{"width": w, "tp": int(t)} for w in WEIGHT_WIDTHS
                   for t, c in sorted(r["widths"][w].get("tp", {}).items())
                   if c.get("fits_hbm")]
        if fits_at:
            only_tp.append({"tier": r["tier"], "fits_at": fits_at})
    only_quant = [
        r["tier"] for r in tiers
        if not r["widths"]["fp32"]["fits_hbm"]
        and not r["widths"]["bf16"]["fits_hbm"]
        and (r["widths"]["int8"]["fits_hbm"]
             or r["widths"]["int4"]["fits_hbm"])
    ]
    return {
        "metric": "serve_largest_fit_tier",
        "value": {w: largest_fit[w] for w in WEIGHT_WIDTHS},
        "unit": f"largest tier under {hbm_gb:g} GB HBM per weight width "
                f"(int8 KV)",
        "scenario": {"max_seqs": max_seqs, "context": context,
                     "page_size": page_size, "weight_block": block,
                     "kv_dtype": "int8", "tp_degrees": list(tp)},
        "hbm_limit_bytes": int(hbm),
        "tiers": tiers,
        "fits_only_quantized": only_quant,
        "fits_only_tensor_parallel": only_tp,
        **({} if draft is None else {
            "draft": draft,
            "draft_co_resident_largest_fit": {
                w: largest_fit_draft[w] for w in WEIGHT_WIDTHS}}),
    }


def materialize_serve_pools(device, tier: str = "1B", width: str = "int8",
                            max_seqs: int = 4, context: int = 1024,
                            page_size: int = 64, block: int = 128) -> Dict:
    """Build ``tier``'s ``width`` weight pool and its int8 KV pool on the
    card and read what they took: ``{"weight_pool_bytes",
    "weight_pool_allocated", "weight_tensors", "kv_pool_bytes",
    "kv_pool_allocated", "kv_tensors"}``, each ``*_bytes`` from the
    pricing (the pool functions' shapes) and each ``*_allocated`` the
    ``torch.cuda.memory_allocated`` delta, which the caching allocator
    rounds up to 512 bytes a tensor.  The fp32 model the pool is
    quantized from is freed before the reading."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving.kv_cache import init_pools

    shape = dict(SERVE_TIERS)[tier]
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    model = GPTModel(GPTConfig(
        vocab_size=shape["vocab"], num_layers=shape["layers"],
        hidden_size=shape["hidden"], num_attention_heads=shape["heads"],
        max_position_embeddings=context, position_embedding="rope",
        compute_dtype=torch.float32), device=device)
    with torch.no_grad():
        pool = serve_pool(model, width, block)
    del model
    torch.cuda.synchronize(device)
    weight_alloc = torch.cuda.memory_allocated(device) - base
    weight_bytes = module_bytes(pool)
    n_weight = len({id(t) for t in list(pool.parameters())
                    + list(pool.buffers())})
    cfg = kv_config(shape["layers"], shape["heads"],
                    shape["hidden"] // shape["heads"], max_seqs=max_seqs,
                    context=context, page_size=page_size,
                    kv_dtype=torch.int8)
    mid = torch.cuda.memory_allocated(device)
    pools = init_pools(cfg, device)
    torch.cuda.synchronize(device)
    kv_alloc = torch.cuda.memory_allocated(device) - mid
    with FakeTensorMode():
        kv_bytes = _kv_pool_bytes(cfg)
    out = {"tier": tier, "width": width,
           "weight_pool_bytes": weight_bytes,
           "weight_pool_allocated": weight_alloc,
           "weight_tensors": n_weight,
           "kv_pool_bytes": kv_bytes, "kv_pool_allocated": kv_alloc,
           "kv_tensors": len(pools)}
    del pool, pools
    torch.cuda.empty_cache()
    return out


def train_argument_bytes(model, opt, tokens, targets) -> int:
    """Exact bytes of what the train step is handed: the parameters, the
    optimizer's state (fp32 masters, both moments, the one step counter,
    made as the first step would) and the token batch."""
    for p in model.parameters():
        opt._state(p)
    seen = {}
    tensors = list(model.parameters()) + [tokens, targets]
    for state in opt.state.values():
        tensors += [t for t in state.values()
                    if isinstance(t, torch.Tensor)]
    for t in tensors:
        seen[id(t)] = t.numel() * t.element_size()
    return sum(seen.values())


def run_train_audit(device=None, steps: int = 2) -> Dict:
    """The flagship O5 train step of ``tools/profile_r05`` on the card:
    its argument bytes, and the peak of a step after ``steps - 1``
    warm-up steps (``max_memory_allocated``); ``temp_bytes`` is the peak
    above the arguments (activations, gradients, workspace)."""
    from apex_tpu_torch.tools import profile_r05

    model, opt, step, n_params = profile_r05.build(device)
    tokens, targets = profile_r05.batch(model.device)
    tokens, targets = tokens.to(torch.int32), targets.to(torch.int32)
    arg = train_argument_bytes(model, opt, tokens, targets)
    for _ in range(max(steps - 1, 0)):
        step(tokens, targets)
    torch.cuda.synchronize(model.device)
    torch.cuda.reset_peak_memory_stats(model.device)
    loss = float(step(tokens, targets))
    peak = torch.cuda.max_memory_allocated(model.device)
    doc = {
        "config": dict(profile_r05.FLAGSHIP, opt_level="O5"),
        "n_params": n_params,
        "argument_bytes": arg,
        "output_bytes": None,
        "temp_bytes": peak - arg,
        "alias_bytes": None,
        "peak_bytes": peak,
        "source": "max_memory_allocated",
        "loss": loss,
        "hbm_limit_bytes": int(card_memory_gb(model.device) * 1e9),
    }
    del model, opt, step
    torch.cuda.empty_cache()
    return doc


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serve", action="store_true",
                    help="serving audit: pool bytes per tier and width")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="the verdicts' limit (default: the card's memory)")
    ap.add_argument("--max-seqs", type=int, default=4)
    ap.add_argument("--context", type=int, default=1024)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--weight-block", type=int, default=128)
    ap.add_argument("--tp", type=int, action="append", default=None)
    ap.add_argument("--draft-tier", default="1B",
                    choices=[n for n, _ in SERVE_TIERS] + ["none"])
    ap.add_argument("--compare", action="store_true",
                    help="ZeRO-3 against DDP (multi-GPU: raises)")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="ZeRO-3 training steps (multi-GPU: raises)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.compare or args.train_steps:
        raise NotImplementedError(
            f"--compare / --train-steps (ZeRO-3 against DDP) {_MULTI_GPU}")
    if args.serve:
        doc = run_serve_audit(
            hbm_gb=args.hbm_gb, max_seqs=args.max_seqs,
            context=args.context, page_size=args.page_size,
            block=args.weight_block,
            tp=tuple(args.tp) if args.tp else SERVE_TP_DEGREES,
            draft_tier=None if args.draft_tier == "none"
            else args.draft_tier)
        name = "memory_audit_serve.json"
        summary = {"metric": doc["metric"], "value": doc["value"],
                   "fits_only_quantized": doc["fits_only_quantized"],
                   "tiers_gb": {r["tier"]: {
                       w: round(r["widths"][w]["total_bytes"] / 1e9, 2)
                       for w in WEIGHT_WIDTHS} for r in doc["tiers"]}}
    else:
        if not torch.cuda.is_available():
            raise SystemExit("the train-step audit runs on a CUDA device")
        doc = run_train_audit()
        name = "memory_audit.json"
        summary = {k: doc[k] for k in ("n_params", "argument_bytes",
                                       "temp_bytes", "peak_bytes")}
    out = args.out or os.path.join(_REPO, "tool_out", name)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(summary))
    print(f"wrote {out}")
    return doc


if __name__ == "__main__":
    main()
