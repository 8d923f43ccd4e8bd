"""The port's one-GPU tools (``apex_tpu_torch/tools/``: memory_audit,
kernel_validation, profile_r05, scale_mfu) against the root ``tools/``
of the JAX package, on the CPU.

- ``memory_audit``'s tp=1 serve audit (every tier's and width's weight
  pool, the KV pools, activations, the draft model, and every verdict
  at one memory limit) equals the JAX tool's ``run_serve_audit(tp=(1,),
  hbm_gb=80)``, priced from the port's own pool functions on fake tensors;
  the train step's argument bytes equal the JAX tool's at world 1;
- ``kernel_validation`` writes every entry kind of the JAX tool's, with
  its record keys, and its gates split: the numeric and identity gates
  fail, the speed and crossover gates are findings;
- ``profile_r05``'s variants are the JAX tool's, its fwd-only loss equals
  its no-optimizer loss (JAX's ``test_no_opt_loss_matches_fwd_only``),
  and ``scale_mfu``'s configurations are JAX's.

The timed parts need the card (``chip_smoke.py`` runs them); here
``device_ms`` is stubbed and the shapes are tiny.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from apex_tpu_torch.tools import kernel_validation as kv
from apex_tpu_torch.tools import memory_audit as tma
from apex_tpu_torch.tools import profile_r05, scale_mfu

torch.set_num_threads(1)  # the suite's parallel workers share the cores

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jma():
    import sys

    sys.path.insert(0, str(ROOT / "tools"))
    import memory_audit

    yield memory_audit
    sys.path.remove(str(ROOT / "tools"))


def _plain(node):
    """JSON-shaped: tuples as lists, numpy scalars as Python's."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    if isinstance(node, np.generic):
        return node.item()
    return node


def test_serve_audit_equals_jax_at_tp1(jma):
    got = _plain(tma.run_serve_audit(hbm_gb=80.0))
    want = _plain(jma.run_serve_audit(hbm_gb=80.0, tp=(1,)))
    assert got == want
    assert got["value"] == {"fp32": "13B", "bf16": "30B", "int8": "70B",
                            "int4": "70B"}


def test_serve_audit_multi_gpu_parts_raise():
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        tma.run_serve_audit(hbm_gb=80.0, tp=(1, 2))
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        tma.main(["--compare"])
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        tma.main(["--train-steps", "2"])


def test_train_argument_bytes_equal_jax_at_world_1(jma):
    from apex_tpu.transformer import parallel_state

    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam

    dims = dict(vocab=256, layers=2, hidden=64, heads=4, seq=16)
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(devices=jax.devices()[:1])
    try:
        _, _, want = jma.build_step("ddp", mesh, jma._model(**dims), batch=4)
    finally:
        parallel_state.destroy_model_parallel()
    model = GPTModel(GPTConfig(
        vocab_size=256, num_layers=2, hidden_size=64, num_attention_heads=4,
        max_position_embeddings=16, compute_dtype=torch.float32),
        device="cpu")
    opt = FusedAdam(model.parameters(), lr=1e-2, master_weights=True)
    toks = torch.zeros((4, 16), dtype=torch.int32)
    assert tma.train_argument_bytes(model, opt, toks, toks.clone()) == want


def _stub(monkeypatch):
    monkeypatch.setattr(kv, "device_ms",
                        lambda fn, iters=10: (fn(), (0.1, "stub"))[1])


def _entries(monkeypatch):
    _stub(monkeypatch)
    dev = torch.device("cpu")
    e = kv.validate_attention(seqs=(64,), dtypes=(torch.bfloat16,),
                              device=dev, tokens=64, heads=2, head_dim=64)
    e += kv.validate_layer_norm(device=dev, shapes=((64, 128),))
    e += kv.validate_softmax(device=dev, shapes=((2, 64, 64),))
    e += kv.validate_fused_dense(device=dev, sizes=(32, 64, 128))
    e += kv.validate_opt_tail(device=dev, sizes=(1, 64))
    e += kv.validate_fmha_decode(device=dev, batches=(2,), caches=(128,),
                                 kvs=("bfloat16", "int8"), sqs=(4,),
                                 sq_kvs=("bfloat16",), sq_cache=128)
    e += kv.validate_dequant_matmul(device=dev, ms=(2,),
                                    shapes=(("qkv", 128, 512),))
    return e


def test_kernel_validation_covers_every_jax_entry_kind(monkeypatch):
    src = (ROOT / "tools" / "kernel_validation.py").read_text()
    jax_kinds = set(re.findall(r'"kernel": "(\w+)"', src)) | set(
        re.findall(r'\(\s*"(\w+)",\s*(?:scaled|\n|lambda)', src))
    assert jax_kinds == set(kv.ENTRY_KINDS)
    entries = _entries(monkeypatch)
    assert {e["kernel"] for e in entries} == set(kv.ENTRY_KINDS)
    for e in entries:
        assert {"kernel", "shape", "dtype"} <= set(e)
        if e["kernel"] == "decode_generation":
            assert {"greedy_match", "chunked_greedy_match",
                    "speculative_greedy_match"} <= set(e)
            continue
        assert "auto_impl" in e
        f = e.get("fwd", e)
        assert {"max_err_vs_fp32", "library_err_vs_fp32"} <= set(f)
    attn = [e for e in entries if e["kernel"] in (
        "flash_attention", "fmha_short", "fmha_mid")]
    assert {e["rung"] for e in attn} == {"short", "mid", "flash"}
    for e in attn:
        assert {"grad_max_rel_err", "library_ms", "kernel_ms"} <= set(
            e["fwd_bwd"])
    bad, found = kv.gates(entries)
    assert bad == [] and found == []
    gen = [e for e in entries if e["kernel"] == "decode_generation"]
    assert gen[0]["greedy_match"] and gen[0]["speculative_greedy_match"]


def test_kernel_validation_gate_split():
    """Numeric and identity gates fail; speed and crossovers are findings
    (the ladder's constants are TPU crossovers)."""
    ok = {"kernel": "fused_layer_norm", "shape": [8, 8], "dtype": "bf16",
          "auto_impl": "kernel", "max_err_vs_fp32": 4e-3,
          "library_err_vs_fp32": 2e-3, "speedup": 0.5}
    bad, found = kv.gates([ok])
    assert bad == [] and len(found) == 1 and found[0].startswith("(2)")
    bad, _ = kv.gates([dict(ok, max_err_vs_fp32=0.02)])
    assert len(bad) == 1 and "fwd err" in bad[0]
    bad, _ = kv.gates([{"kernel": "decode_generation", "shape": [4],
                        "dtype": "float32", "greedy_match": True,
                        "chunked_greedy_match": False,
                        "speculative_greedy_match": True}])
    assert len(bad) == 1 and "chunked_greedy_match" in bad[0]

    def row(rung, s, f_ms, causal=True):
        return {"kernel": kv.RUNGS[rung][0], "rung": rung,
                "shape": [1, 8, s, 128], "dtype": "bfloat16",
                "causal": causal, "auto_impl": kv._auto_rung(s),
                "fwd": {"kernel_ms": f_ms, "library_ms": 1.0,
                        "speedup": 1.0 / f_ms, "max_err_vs_fp32": 0.0,
                        "library_err_vs_fp32": 0.0},
                "fwd_bwd": {"kernel_ms": f_ms, "library_ms": 1.0,
                            "speedup": 1.0 / f_ms, "grad_max_rel_err": 0.01,
                            "library_grad_max_rel_err": 0.01}}
    # mid faster than short at s=512: a crossover finding, not a failure
    entries = [row("short", 512, 0.5), row("mid", 512, 0.4),
               row("flash", 512, 0.9)]
    bad, found = kv.gates(entries)
    assert bad == []
    assert any(f.startswith("(3)") and "s=512" in f for f in found)
    x = kv.crossovers(entries)["by_case"]["bfloat16 causal"]
    assert x["hand_over"]["fwd short->mid"] == 512
    assert x["fastest"]["fwd_bwd"] == {512: "mid"}
    bad, _ = kv.gates([dict(entries[0], fwd_bwd=dict(
        entries[0]["fwd_bwd"], grad_max_rel_err=0.2))])
    assert "grad rel err" in bad[0]


def test_profile_r05_variants_are_jax_s():
    src = (ROOT / "tools" / "profile_r05.py").read_text()
    block = src[src.index("for label, kw in ("):src.index("):\n        try")]
    jax_labels = re.findall(r'\("([^"]+)", \{', block)
    assert [label for label, _ in profile_r05.VARIANTS] == jax_labels
    assert set(profile_r05.NOT_RUN) == {"attention xla"}
    assert set(profile_r05.SAME_PROGRAM) == {"remat dots_saveable"}
    assert profile_r05.HEADLINE == "headline (bf16+remat+autoCE)"
    assert profile_r05.FLAGSHIP == dict(
        vocab_size=32768, num_layers=12, hidden_size=1024,
        num_attention_heads=8, seq=1024, batch=8)
    with pytest.raises(NotImplementedError):
        profile_r05.build("cpu", vocab_size=64, num_layers=1,
                          hidden_size=64, num_attention_heads=2,
                          max_position_embeddings=16, attention_impl="xla")


def test_no_opt_loss_matches_fwd_only():
    small = dict(vocab_size=64, num_layers=1, hidden_size=64,
                 num_attention_heads=2, max_position_embeddings=16)
    losses = {}
    for variant in ("_no_opt", "_fwd_only", "_opt_only"):
        _, _, step, _ = profile_r05.build("cpu", **small, **{variant: True})
        toks, tgts = profile_r05.batch("cpu", 4, 16, 64, seed=2)
        losses[variant] = float(step(toks, tgts))
    assert losses["_no_opt"] == pytest.approx(losses["_fwd_only"], rel=1e-6)
    assert losses["_opt_only"] == losses["_fwd_only"]


def test_opt_only_step_moves_the_parameters_with_zero_gradients():
    small = dict(vocab_size=64, num_layers=1, hidden_size=64,
                 num_attention_heads=2, max_position_embeddings=16)
    model, opt, step, _ = profile_r05.build("cpu", **small, _opt_only=True)
    before = [p.detach().clone() for p in model.parameters()]
    step(*profile_r05.batch("cpu", 2, 16, 64))
    # Adam over zero gradients: zero moments, no move (weight decay 0)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    assert all(p.grad is not None and not p.grad.any()
               for p in model.parameters())


def test_scale_mfu_configs_are_jax_s():
    src = (ROOT / "tools" / "scale_mfu.py").read_text()
    jax_configs = [(t, int(a), int(b), int(c), int(d)) for t, a, b, c, d in
                   re.findall(r'\("(\w+)", (\d+), (\d+), (\d+), (\d+)\)',
                              src)]
    assert scale_mfu.CONFIGS == jax_configs


@pytest.mark.parametrize("main", [profile_r05.main, scale_mfu.main,
                                  kv.main, lambda a: tma.main(a)])
def test_timed_tools_need_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        main([])
