"""The port's chaos drill (``apex_tpu_torch/tools/chaos_drill.py``)
against the JAX package's (``tools/chaos_drill.py``), on the CPU.

Both legs of ``tests/test_chaos_drill.py``:

- the in-process matrix (replica kill, quarantine by repeated faults, a
  transient fault, brownout, deadlines and hedging, the journal's
  overhead) over the JAX tool's world with its weights converted
  (``jm.init(PRNGKey(7))``) and its trace: the ledger equals the JAX
  tool's run in this process, but for the wall-clock fields, and the
  unfaulted fleets' streams are equal token for token;
- the SIGKILL restart drill as the port runs it, across real processes;
  its in-process parts against JAX's (a JAX child process is too slow
  for this tier): the same drill requests, and the never-killed
  reference child's streams over the int8 pool of the converted weights.

``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper
while the JAX tool runs (jax 0.9's replication check rejects the fleet's
decode step otherwise; ROADMAP "Reference health").
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import apex_tpu._compat
from apex_tpu_torch import convert
from apex_tpu_torch.tools import chaos_drill as tcd

torch.set_num_threads(1)  # the suite's parallel workers share the cores

ROOT = Path(__file__).resolve().parent.parent
#: the ledger's wall-clock fields, which no two runs share
TIMED = {"wall_s", "write_s", "frac"}


@pytest.fixture(scope="module")
def jcd():
    """The JAX tool, with the check=False shard_map."""
    original = apex_tpu._compat.shard_map

    def shard_map(f, mesh, in_specs, out_specs, check=True):
        return original(f, mesh, in_specs, out_specs, check=False)

    sys.path.insert(0, str(ROOT))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(apex_tpu._compat, "shard_map", shard_map)
        from tools import chaos_drill

        yield chaos_drill
    sys.path.remove(str(ROOT))
    assert apex_tpu._compat.shard_map is original


@pytest.fixture(scope="module")
def jax_state(jcd):
    """The JAX tool's seeded parameters, as the port's state dict."""
    _, params, _, _, _ = jcd._mk_world()
    return convert.params_from_jax(jax.tree.map(np.asarray, params))


def _untimed(node):
    if isinstance(node, dict):
        return {k: _untimed(v) for k, v in node.items() if k not in TIMED}
    return node


def test_matrix_ledger_equals_jax(jcd, jax_state):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcd.run_matrix() == 0
    (line,) = [l for l in buf.getvalue().splitlines()
               if l.startswith("CHAOS ")]
    want = json.loads(line[len("CHAOS "):])
    got = tcd.run_matrix(tcd.World(tcd.tiny_model("cpu", jax_state)))
    assert got.pop("problems") == []
    assert _untimed(got) == _untimed(want)
    assert got["zero_loss"] and got["token_identical"]
    sc = got["scenarios"]
    assert sc["nonfinite_quarantine"]["quarantined"] == "faults"
    assert sc["brownout"]["transitions"] >= 1
    assert sc["deadline_hedge"]["deadline_misses"] >= 1
    assert sc["deadline_hedge"]["hedges"] >= 1
    assert sc["journal_overhead"]["frac"] < 0.02
    assert tcd.print_ledger(dict(got, problems=[])) == 0


def test_unfaulted_streams_equal_jax(jcd, jax_state):
    from apex_tpu.fleet import FleetRouter as JaxRouter
    from tools.load_gen import replay as jreplay

    from apex_tpu_torch.fleet import FleetRouter
    from apex_tpu_torch.tools.load_gen import replay

    _, _, ccfg, fns, maxp = jcd._mk_world()
    ref = JaxRouter(jcd._mk_replicas(ccfg, fns, maxp))
    jreplay(ref, jcd._mk_trace())
    world = tcd.World(tcd.tiny_model("cpu", jax_state))
    got = FleetRouter(world.replicas())
    replay(got, tcd.make_trace(world.model.config.vocab_size))
    assert len(got.completions) == 24
    assert tcd._streams(got) == {u: list(c.tokens) for u, c in
                                 ref.completions.items()}


def test_matrix_reports_a_broken_promise():
    """A faulted run whose stream differs is a violation, and the ledger
    line says the drill failed."""
    bad = tcd._check_identity("kill", {"u1": [1, 2, 3]}, {"u1": [1, 2, 4]})
    assert bad == ["kill: u1 diverged (got 3 toks, want 3)"]
    assert tcd._check_identity("deadline", {"u1": [1, 2]},
                               {"u1": [1, 2, 4]}, allow_prefix={"u1"}) == []
    assert tcd.print_ledger({"requests": 1, "problems": bad}) == 1


def test_restart_drill_sigkill_mid_serve(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.tools.chaos_drill",
         "--device", "cpu", "--subprocess", "--root", str(tmp_path / "d")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "chaos drill PASSED" in proc.stdout
    (line,) = [l for l in proc.stdout.splitlines() if l.startswith("CHAOS ")]
    led = json.loads(line[len("CHAOS "):])
    assert set(led) == {"mode", "requests", "killed_at_window", "replayed",
                        "token_identical", "zero_loss"}
    assert led["zero_loss"] and led["token_identical"]
    assert led["replayed"]["resumed"] >= 1
    assert led["replayed"]["corrupt"] == 0


def test_restart_drill_parts_equal_jax(jcd, jax_state, tmp_path):
    """The drill's requests, and the reference child's streams over the
    int8 pool of the same weights."""
    want_reqs = jcd._drill_requests()
    got_reqs = tcd.drill_requests()
    assert [(r.uid, r.prompt, r.max_new_tokens, r.seed) for r in got_reqs] \
        == [(r.uid, list(r.prompt), r.max_new_tokens, r.seed)
            for r in want_reqs]
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    jroot.mkdir()
    troot.mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        # the JAX reference child's leg, in this process, over its pool
        assert jcd.run_child(str(jroot), "ref") == 0
    want = json.loads((jroot / "streams_ref.json").read_text())

    from apex_tpu_torch.fleet import FleetRouter

    world = tcd.quantized_world(str(troot), restore=False, device="cpu",
                                state=jax_state)
    router = FleetRouter(world.replicas())
    for q in got_reqs:
        assert router.submit(q)
    router.drain()
    assert tcd._streams(router) == want
    # and the second life re-derives the same pool from the checkpoint
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcd.quantized_world(str(troot), restore=True, device="cpu")
    assert "QPOOL_IDENTICAL" in out.getvalue()
