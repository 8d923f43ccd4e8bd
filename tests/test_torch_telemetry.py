"""The port's telemetry (``apex_tpu_torch.telemetry``,
``apex_tpu_torch.transformer.log_util``) against the JAX package's, on the
CPU.

JAX's ``tests/test_telemetry.py`` does not collect on this host, so its
classes are not the oracle: the JAX modules themselves are.  The same
calls go through both packages' ``MetricsLogger`` (JAX with ``jnp``
scalars, the port with torch tensors) and the JSONL records are held
equal, wall times (``t``, the timings' values) left out; so are the
console lines, ``StepStats``' rates on an injected clock, the event bus,
``ring_wire_bytes``, the checkpoint's and the fused optimizer tail's
events, and the transformer loggers.  The port's ``_device_get`` runs
once per flush.  ``TraceTrigger`` arms, captures a ``torch.profiler``
window and re-arms as JAX's ``TestTraceTrigger`` has it.
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.telemetry import events as jevents
from apex_tpu.telemetry import metrics as jmetrics
from apex_tpu.transformer import log_util as jlog
from apex_tpu_torch.telemetry import PHASES, TraceTrigger
from apex_tpu_torch.telemetry import events as tevents
from apex_tpu_torch.telemetry import metrics as tmetrics
from apex_tpu_torch.telemetry.spans import TRACE_FILE
from apex_tpu_torch.transformer import log_util as tlog

torch.set_num_threads(1)  # the suite's parallel workers share the cores


class Sink:
    def __init__(self):
        self.evs = []

    def event(self, kind, **fields):
        self.evs.append((kind, fields))

    def of(self, kind):
        return [f for k, f in self.evs if k == kind]


@pytest.fixture
def sink():
    cap = Sink()
    tevents.add_sink(cap)
    try:
        yield cap
    finally:
        tevents.remove_sink(cap)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _scrub(recs):
    """Records without wall times: ``t``, and timings' values."""
    out = []
    for r in recs:
        r = {k: v for k, v in r.items() if k != "t"}
        if "timings_ms" in r:
            r["timings_ms"] = sorted(r["timings_ms"])
        out.append(r)
    return out


# ------------------------------------------------------------- event bus
def test_event_bus_matches_jax():
    assert not tevents.have_sinks()
    tevents.emit("nobody", x=1)                   # no sink: a no-op
    got = {}
    for name, ev in (("jax", jevents), ("port", tevents)):
        cap, boom = Sink(), Sink()
        boom.event = lambda kind, **f: 1 / 0       # a sink that raises
        with ev.sink(cap):
            ev.add_sink(boom)
            ev.add_sink(cap)                       # twice: still once
            ev.emit("a", x=1, y=[1, 2])
            ev.remove_sink(boom)
            ev.remove_sink(boom)                   # unknown: ignored
        ev.emit("b", x=2)                          # after removal
        with pytest.raises(TypeError):
            ev.add_sink(object())
        got[name] = cap.evs
    assert got["port"] == got["jax"] == [("a", {"x": 1, "y": [1, 2]})]
    assert not tevents.have_sinks()


@pytest.mark.parametrize("op", ["all-reduce", "all-gather",
                                "reduce-scatter", "all-to-all",
                                "collective-permute"])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_ring_wire_bytes_matches_jax(op, g):
    for args in ((1000.0,), (1000.0, 4000.0)):
        assert tevents.ring_wire_bytes(op, g, *args) == \
            jevents.ring_wire_bytes(op, g, *args)


# --------------------------------------------------------- MetricsLogger
def _script(mod, scalar, path, lines):
    """One sequence of logger calls; ``scalar`` makes a device value."""
    tlm = mod.MetricsLogger(jsonl_path=path, flush_every=3, run="r",
                            print_fn=lines.append)
    tlm.counter("saves")
    tlm.counter("saves", 2)
    tlm.gauge("scale", 128.0)
    tlm.gauge("gnorm", scalar(0.5, "f"))
    with tlm.timing("data"):
        pass
    for i in range(7):
        tlm.log_scalars(i, loss=scalar(1.0 + i / 8, "f"),
                        finite=scalar(i % 2 == 0, "b"),
                        tokens=scalar(64 * i, "i"), lr=3e-4, tag="x")
        if i == 4:
            tlm.event("checkpoint_save", path="/x", bytes=12)
            tlm.gauge("pages_free", 7)
    tlm.close()
    return tlm


def _jax_scalar(v, kind):
    return {"f": jnp.float32, "b": jnp.bool_, "i": jnp.int32}[kind](v)


def _port_scalar(v, kind):
    return torch.tensor(v, dtype={"f": torch.float32, "b": torch.bool,
                                  "i": torch.int32}[kind])


def test_logger_records_match_jax(tmp_path, monkeypatch):
    """The same calls give JAX's records (step, meters and event records
    with ``run``), JAX's console lines, and one ``_device_get`` a flush
    over every pending tensor (3 flushes: 3 + 3 steps, then close)."""
    calls = []
    real = tmetrics._device_get
    monkeypatch.setattr(tmetrics, "_device_get",
                        lambda h: (calls.append(len(h)), real(h))[1])
    jl, tl = [], []
    jt = _script(jmetrics, _jax_scalar, str(tmp_path / "j.jsonl"), jl)
    tt = _script(tmetrics, _port_scalar, str(tmp_path / "t.jsonl"), tl)
    jr = _scrub(read_jsonl(tmp_path / "j.jsonl"))
    tr = _scrub(read_jsonl(tmp_path / "t.jsonl"))
    assert tr == jr
    assert [r["kind"] for r in tr].count("step") == 7
    assert tl == jl and len(tl) == 3
    # 3 step scalars a step and the device gauge
    assert calls == [3 * 3 + 1, 3 * 3 + 1, 3 * 1 + 1]
    assert tt.n_resolves == jt.n_resolves == 3
    assert tt.n_flushes == jt.n_flushes
    assert tt.last == jt.last and tt.last_step == jt.last_step == 6
    assert tt.overhead_s >= 0 and tt.resolve_wait_s >= 0


def test_log_scalars_keeps_tensors_unresolved(monkeypatch):
    calls = []
    monkeypatch.setattr(tmetrics, "_device_get",
                        lambda h: calls.append(h) or [0.0] * len(h))
    tlm = tmetrics.MetricsLogger(console=False, flush_every=4)
    x = torch.tensor(2.0)
    tlm.log_scalars(0, loss=x)
    assert calls == [] and tlm._pending[0][2]["loss"] is x
    tlm.close()
    assert len(calls) == 1


def test_flush_every_one_and_validation():
    tlm = tmetrics.MetricsLogger(console=False, flush_every=1)
    tlm.log_scalars(0, loss=torch.tensor(1.5))
    assert tlm.last == {"loss": 1.5}
    with pytest.raises(ValueError):
        tmetrics.MetricsLogger(flush_every=0)


def test_other_ranks_write_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(tmetrics, "_rank", lambda: 1)
    path = tmp_path / "m.jsonl"
    tlm = tmetrics.MetricsLogger(jsonl_path=str(path), console=False)
    tlm.log_scalars(0, loss=torch.tensor(1.0))
    tlm.event("x")
    tlm.close()
    assert tlm.rank == 1 and not path.exists()
    tlm = tmetrics.MetricsLogger(jsonl_path=str(path), console=False,
                                 process_zero_only=False)
    tlm.log_scalars(0, loss=1.0)
    tlm.close()
    assert [r["kind"] for r in read_jsonl(path)] == ["step"]


def test_attach_events_and_close_deregisters(tmp_path):
    path = tmp_path / "m.jsonl"
    tlm = tmetrics.MetricsLogger(jsonl_path=str(path),
                                 console=False).attach_events()
    tevents.emit("guard_warn", step=3)
    tlm.close()
    tevents.emit("guard_warn", step=4)
    assert not tevents.have_sinks()
    (rec,) = read_jsonl(path)
    assert rec["event"] == "guard_warn" and rec["step"] == 3


# -------------------------------------------------------------- StepStats
def _stats_script(mod):
    t = [0.0]
    stats = mod.StepStats(tokens_per_step=100, flops_per_token=10,
                          peak_flops=1e4, time_fn=lambda: t[0])
    out = [stats.interval(), stats.summary()]
    t[0] = 5.0
    stats.begin()
    t[0] = 6.0
    stats.tick(10)
    out += [stats.interval(), stats.interval()]
    t[0] = 8.0
    stats.tick(5)
    out += [stats.interval(), stats.summary(), stats.timed_steps]
    return out


def test_step_stats_match_jax():
    assert _stats_script(tmetrics) == _stats_script(jmetrics)
    assert tmetrics.transformer_flops_per_token(1000, 2, 8, 16) == \
        jmetrics.transformer_flops_per_token(1000, 2, 8, 16)
    assert tmetrics.device_peak_flops("cpu") is None


def test_step_stats_through_the_logger(tmp_path):
    """A logger with stats writes JAX's throughput record shape."""
    t = [0.0]
    recs = {}
    for name, mod, sc in (("j", jmetrics, _jax_scalar),
                          ("t", tmetrics, _port_scalar)):
        t[0] = 0.0
        stats = mod.StepStats(tokens_per_step=8, flops_per_token=2,
                              peak_flops=32.0, time_fn=lambda: t[0])
        path = str(tmp_path / f"{name}.jsonl")
        tlm = mod.MetricsLogger(jsonl_path=path, console=False,
                                flush_every=2, stats=stats)
        for i in range(4):
            t[0] += 1.0
            if i == 0:
                stats.begin(sc(1.0, "f"))
            else:
                stats.tick()
            tlm.log_scalars(i, loss=sc(1.0, "f"))
        tlm.close()
        recs[name] = _scrub(read_jsonl(path))
    assert recs["t"] == recs["j"]
    assert [r["kind"] for r in recs["t"]].count("throughput") == 2


# ------------------------------------------------------------ TraceTrigger
def test_trace_touch_file_capture_and_rearm(tmp_path, sink):
    tdir = str(tmp_path / "traces")
    trig = TraceTrigger(trace_dir=tdir, steps=2, poll_every=1)
    assert not trig.poll(0)                        # nothing armed
    open(trig.trigger_file, "w").close()           # arm
    assert trig.poll(1)                            # capture opens
    assert not os.path.exists(trig.trigger_file)   # consumed
    torch.randn(8, 8) @ torch.randn(8, 8)
    assert trig.poll(2)                            # window step 1
    assert not trig.poll(3)                        # window closed
    assert trig.captures == 1
    out = os.path.join(tdir, "step1")
    assert os.listdir(out) == [TRACE_FILE]
    assert json.load(open(os.path.join(out, TRACE_FILE)))
    open(trig.trigger_file, "w").close()           # re-touch re-arms
    assert trig.poll(4)
    trig.close()
    assert trig.captures == 2
    assert [k for k, _ in sink.evs] == ["trace_start", "trace_captured"] * 2
    assert sink.of("trace_start")[0] == {"dir": out, "step": 1, "window": 2}
    assert sink.of("trace_captured")[0] == {"dir": out, "step": 3,
                                            "window": 2}


def test_trace_dir_override_env_arming_and_validation(tmp_path,
                                                      monkeypatch, sink):
    other = str(tmp_path / "elsewhere")
    trig = TraceTrigger(trace_dir=str(tmp_path / "traces"), steps=1)
    with open(trig.trigger_file, "w") as f:
        f.write(other + "\n")
    assert trig.poll(7)
    trig.close()
    assert os.path.isfile(os.path.join(other, "step7", TRACE_FILE))
    monkeypatch.setenv("APEX_TPU_TRACE_DIR", str(tmp_path / "envtrace"))
    monkeypatch.setenv("APEX_TPU_TRACE_STEPS", "1")
    trig = TraceTrigger()
    assert trig.steps == 1
    assert trig.poll(0)                            # armed by env
    assert not trig.poll(1)
    assert not trig.poll(2)                        # one-shot
    assert trig.captures == 1
    with pytest.raises(ValueError):
        TraceTrigger(poll_every=0)
    with pytest.raises(ValueError):
        TraceTrigger(steps=0)


def test_phases_are_jax_s():
    from apex_tpu.telemetry.spans import PHASES as JPHASES

    assert PHASES == JPHASES


# --------------------------------------------------- subsystem events
def _checkpoint_events(ck, ev, root, tree):
    cap = Sink()
    ev.add_sink(cap)
    try:
        ck.save_step(root, 1, tree)
        ck.save_step(root, 2, tree)
        ck.verify(os.path.join(root, "step_1"))
        ck.restore(os.path.join(root, "step_1"), verify_integrity=True,
                   **({"target": tree} if ck.__name__.startswith(
                       "apex_tpu_torch") else {}))
        with open(os.path.join(root, "step_2", "data.bin"), "r+b") as f:
            f.write(b"\xff" * 4)
        ck.restore_latest_valid(root)
    finally:
        ev.remove_sink(cap)
    return [(k, {n: (v.replace(root, "<root>") if isinstance(v, str)
                     else v) for n, v in f.items()
                 if n not in ("duration_s", "error")})
            for k, f in cap.evs]


def test_checkpoint_events_match_jax(tmp_path):
    from apex_tpu import checkpoint as jck
    from apex_tpu_torch import checkpoint as tck

    j = _checkpoint_events(jck, jevents, str(tmp_path / "j"),
                           {"w": np.arange(8.0, dtype=np.float32)})
    t = _checkpoint_events(tck, tevents, str(tmp_path / "t"),
                           {"w": torch.arange(8.0)})
    assert t == j
    assert [k for k, _ in t] == [
        "checkpoint_save", "checkpoint_save", "checkpoint_verify",
        "checkpoint_restore", "checkpoint_corrupt_fallback",
        "checkpoint_restore"]


def test_opt_tail_event_matches_jax(sink):
    """A fused-tail step emits JAX's ``opt_tail`` record for the same
    leaves and bucket size; nothing is emitted without a sink."""
    from apex_tpu.optimizers import fused_tail as jtail
    from apex_tpu_torch.optimizers import FusedAdam

    shapes = [(300, 40), (40,), (7, 300), (5000,)]
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    opt = FusedAdam(params, lr=1e-3, master_weights=True, fused_tail=True,
                    bucket_bytes=16384)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    (got,) = sink.of("opt_tail")
    jsink = Sink()
    jevents.add_sink(jsink)
    try:
        jopt = types_ns(exp_avg_sq_dtype=jnp.float32, master_weights=True)
        jtail.emit_opt_tail_event(
            jopt, jtail.tail_plan([np.zeros(s, np.float32) for s in shapes],
                                  16384), unscale_folded=False)
    finally:
        jevents.remove_sink(jsink)
    assert got == jsink.of("opt_tail")[0]
    assert got["buffers"] > 1 and got["elements"] == sum(
        int(np.prod(s)) for s in shapes)


def types_ns(**kw):
    import types

    return types.SimpleNamespace(**kw)


# --------------------------------------------------------------- log_util
def test_transformer_loggers_match_jax():
    tl = tlog.get_transformer_logger("layers.py")
    jl = jlog.get_transformer_logger("layers.py")
    assert tl.name == "apex_tpu_torch.transformer.layers"
    assert jl.name == "apex_tpu.transformer.layers"
    root = logging.getLogger("apex_tpu_torch.transformer")
    assert any(isinstance(h, logging.NullHandler) for h in root.handlers)
    try:
        for level in ("debug", "INFO", logging.WARNING, 40):
            tlog.set_logging_level(level)
            jlog.set_logging_level(level)
            assert root.level == logging.getLogger(
                "apex_tpu.transformer").level
        for bad in (True, 1.5, "chatty"):
            with pytest.raises((TypeError, ValueError)) as terr:
                tlog.set_logging_level(bad)
            with pytest.raises((TypeError, ValueError)) as jerr:
                jlog.set_logging_level(bad)
            assert type(terr.value) is type(jerr.value)
            assert str(terr.value) == str(jerr.value)
    finally:
        root.setLevel(logging.NOTSET)
        logging.getLogger("apex_tpu.transformer").setLevel(logging.NOTSET)
