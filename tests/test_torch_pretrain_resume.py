"""Stop, checkpoint and resume the port's trainers on the CPU, and resume a
JAX trainer's checkpoint in the port's.

- ``gpt_pretrain`` (tiny GPT; fp32 at O0, and bf16 at O5 with the packed
  optimizer tail) stopped by a real SIGTERM after a save, then resumed in
  a fresh trainer, gives the uninterrupted run's losses and final
  parameters bit for bit; the JSONL holds a step record a step and the
  checkpoint and autoresume events, and ``tools/metrics_report.py``
  reads it.
- A checkpoint the JAX trainer (``examples/gpt_pretrain.py``, O0) wrote
  resumes in the port's trainer, whose next losses are the JAX run's
  within ``tests/test_torch_gpt_train.py``'s fp32 band (rtol 1e-5).
- ``imagenet_amp --checkpoint-dir`` then ``--resume`` equals the
  uninterrupted two epochs.
"""

import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from apex_tpu_torch import checkpoint
from apex_tpu_torch.data import write_token_file
from apex_tpu_torch.examples import gpt_pretrain, imagenet_amp

torch.set_num_threads(1)  # the suite's parallel workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--vocab", "256", "--layers", "2", "--hidden", "64", "--heads", "2",
        "--seq", "32", "--micro-batch", "2", "--num-micro", "1", "--lr",
        "3e-3", "--device", "cpu"]


def _state(tr):
    return {k: v.clone() for k, v in tr.model.state_dict().items()}


@pytest.mark.parametrize("level", [["--opt-level", "O0"],
                                   ["--opt-level", "O5",
                                    "--fused-opt-tail"]],
                         ids=["O0", "O5-fused-tail"])
def test_sigterm_stop_and_resume_equals_uninterrupted(level, tmp_path):
    data = str(tmp_path / "tok.bin")
    write_token_file(data, np.random.default_rng(0).integers(0, 256, 3000))
    base = TINY + level + ["--steps", "9", "--data", data, "--log-every",
                           "3", "--pool", "4"]
    ref = gpt_pretrain.main(base)
    jsonl = str(tmp_path / "m.jsonl")
    resumable = base + ["--checkpoint-dir", str(tmp_path / "ck"),
                        "--save-every", "3", "--metrics-jsonl", jsonl]

    def hook(i, tr):
        if i == 4:                      # after step 3's save
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    first = gpt_pretrain.run(gpt_pretrain.parse_args(resumable),
                             step_hook=hook)
    assert signal.getsignal(signal.SIGTERM) == prev   # handler put back
    assert first["stopped_at"] == 5
    assert first["losses"] == ref["losses"][:6]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_3", "step_5"]
    second = gpt_pretrain.run(gpt_pretrain.parse_args(resumable))
    assert second["start"] == 6
    assert second["losses"] == ref["losses"][6:]
    want, got = _state(ref["trainer"]), _state(second["trainer"])
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert checkpoint.verify(str(tmp_path / "ck" / "step_8")) == []
    recs = [json.loads(x) for x in open(jsonl)]
    steps = [r for r in recs if r["kind"] == "step"]
    assert [r["step"] for r in steps] == list(range(9))
    assert [r["loss"] for r in steps] == pytest.approx(
        ref["losses"], rel=0, abs=0)
    events = [r["event"] for r in recs if r["kind"] == "event"]
    for kind in ("checkpoint_save", "checkpoint_restore",
                 "autoresume_fresh", "autoresume_resume", "autoresume_gc"):
        assert kind in events
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "tools", "metrics_report.py"),
                          jsonl], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "steps 0..8 (9 logged)" in out.stdout


def _jax_trainer():
    import apex_tpu._compat

    spec = importlib.util.spec_from_file_location(
        "jax_gpt_pretrain", os.path.join(REPO, "examples", "gpt_pretrain.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    original = apex_tpu._compat.shard_map

    def shard_map(f, mesh, in_specs, out_specs, check=True):
        # jax 0.9's vma check rejects the trainer's out_specs=P() here
        return original(f, mesh, in_specs, out_specs, check=False)

    mod.shard_map = shard_map
    return mod


def test_port_trainer_resumes_a_jax_trainer_checkpoint(tmp_path):
    from apex_tpu.transformer import parallel_state

    import jax

    jg = _jax_trainer()
    jroot, jsonl = str(tmp_path / "jck"), str(tmp_path / "j.jsonl")
    # the JAX trainer's data axis spans every (virtual) device: a global
    # batch of one row a device, the port's one batch of as many rows
    dp = jax.device_count()
    flags = [f for f in TINY if f not in ("--device", "cpu")] + [
        "--opt-level", "O0", "--log-every", "1", "--micro-batch", "1"]
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    try:
        jg.main(flags + ["--steps", "6", "--save-every", "3",
                         "--checkpoint-dir", jroot,
                         "--metrics-jsonl", jsonl])
    finally:
        parallel_state.destroy_model_parallel()
    jloss = {r["step"]: r["loss"] for r in map(json.loads, open(jsonl))
             if r["kind"] == "step"}
    proot = str(tmp_path / "pck")
    os.makedirs(proot)
    shutil.copytree(os.path.join(jroot, "step_3"),
                    os.path.join(proot, "step_3"))
    assert os.path.isfile(os.path.join(proot, "step_3", "treedef.pkl"))
    out = gpt_pretrain.main(TINY + ["--opt-level", "O0", "--steps", "6",
                                    "--micro-batch", str(dp),
                                    "--checkpoint-dir", proot])
    assert out["start"] == 4
    np.testing.assert_allclose(out["losses"], [jloss[4], jloss[5]],
                               rtol=1e-5)
    # the port's own checkpoint of the continued run: JAX's leaves
    jm = json.load(open(os.path.join(jroot, "step_5", "manifest.json")))
    pm = json.load(open(os.path.join(proot, "step_5", "manifest.json")))
    assert pm["leaves"] == jm["leaves"]


def test_imagenet_resume_equals_uninterrupted(tmp_path):
    """The resumed run's losses and final weights are the uninterrupted
    run's, bit for bit.  oneDNN's convolution backward on the CPU is not
    deterministic run to run at this shape (two uninterrupted runs leave
    ~0.1% of ``stages.3.0.conv1`` a few 1e-3 apart), so the runs take
    PyTorch's native CPU convolution, which is."""
    flags = ["--depth", "18", "--batch-size", "2", "--image-size", "16",
             "--num-classes", "10", "--steps-per-epoch", "2",
             "--eval-steps", "1", "--device", "cpu"]
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    with torch.backends.mkldnn.flags(enabled=False):
        full = imagenet_amp.main(flags + ["--epochs", "2"])
        imagenet_amp.main(flags + ["--epochs", "1"] + ck)
        again = imagenet_amp.main(flags + ["--epochs", "2", "--resume"] + ck)
    assert again["start_epoch"] == 1
    assert again["losses"] == full["losses"]
    want, got = full["model"].state_dict(), again["model"].state_dict()
    assert all(torch.equal(want[k], got[k]) for k in want)
