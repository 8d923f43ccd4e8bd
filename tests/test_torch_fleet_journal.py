"""The port's request journal against the JAX package's, on the CPU.

The journal's on-disk format is the contract (docs/resilience.md, "The
serving journal on disk"): JSONL, one CRC-sealed record a line, appended
with one ``os.write`` on an ``O_APPEND`` fd.  Held here:

- the same sequence of log events journaled by each package gives files
  equal byte for byte (admits with and without a seed or a deadline,
  progress deltas, completions, a handoff record, a restart's ``prime``);
- each package recovers the other's journal to the same state (requests,
  classes, deadlines, streams, completions, counts);
- a flipped payload byte, a torn tail and a lost delta are detected as
  JAX detects them (``corrupt``, and ``gapped`` freezing the stream at the
  consistent prefix), on files damaged by the port's ``faults`` helpers,
  which damage a file as JAX's do;
- a restart: the tiny GPT of ``tests/test_torch_fleet.py`` served partway
  by a journaled fleet, the router abandoned, then ``recover_journal`` +
  ``resume_from_journal`` on fresh batchers over the same weights gives
  every stream of the unkilled run, in both packages alike, and the port
  resumes a journal the JAX fleet wrote.

``apex_tpu._compat.shard_map`` is swapped for a ``check=False`` wrapper,
as in ``tests/test_torch_fleet.py``.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu._compat
from apex_tpu import fleet as jfleet
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.resilience import faults as jfaults
from apex_tpu.serving import kv_cache as jkv
from apex_tpu.serving import serve as jserve
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert
from apex_tpu_torch import fleet as tfleet
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.resilience import faults as tfaults
from apex_tpu_torch.serving import kv_cache as tkv
from apex_tpu_torch.serving import serve as tserve

torch.set_num_threads(1)  # the suite's parallel workers share the cores

PACKAGES = {"jax": types.SimpleNamespace(fleet=jfleet, serve=jserve,
                                         faults=jfaults),
            "port": types.SimpleNamespace(fleet=tfleet, serve=tserve,
                                          faults=tfaults)}


def _admit(side, log, journal, uid, *, plen=4, new=6, seed=7,
           slo="interactive", deadline=None, t=1.0):
    e = log.admit(side.serve.Request(uid=uid, prompt=list(range(1, plen + 1)),
                                     max_new_tokens=new, seed=seed),
                  slo=slo, replica="r0", t_arrive=t)
    if deadline is not None:
        e.deadline_rel = deadline
    journal.admit(e)
    return e


def _events_basic(side, path):
    log, j = side.fleet.RequestLog(), side.fleet.RequestJournal(path)
    _admit(side, log, j, "a", deadline=2.5)
    _admit(side, log, j, "b", seed=None, slo="batch", t=1.25)
    _admit(side, log, j, 7, plen=9, new=3, seed=123456789)
    log.record_progress("r0", {"a": [5, 6], 7: [11]}, now=2.0)
    j.sync(log)
    log.record_progress("r0", {"a": [5, 6, 7]}, now=3.0)
    log.complete("b", [9], "eos", now=3.0)
    j.handoff("a", "r0", "r1")
    log.handoff("a", "r1")
    j.sync(log)
    log.record_progress("r1", {"a": [5, 6, 7, 8, 9]}, now=4.0)
    log.complete(7, [11, 12, 13], "budget", now=4.0)
    j.sync(log)
    j.close()
    return j


def _events_restart(side, path):
    """A journal, a restart that primes a fresh journal on the same path,
    and more tokens after it."""
    log, j = side.fleet.RequestLog(), side.fleet.RequestJournal(path)
    _admit(side, log, j, "a")
    _admit(side, log, j, "c", plen=2, new=2)
    log.record_progress("r0", {"a": [5, 6], "c": [1]}, now=2.0)
    j.sync(log)
    j.close()
    log2 = side.fleet.RequestLog()
    e2 = log2.admit(side.serve.Request(uid="a", prompt=[1, 2, 3, 4],
                                       max_new_tokens=6, seed=7),
                    slo="interactive", replica="r0", t_arrive=9.0)
    e2.emitted = [5, 6]
    j2 = side.fleet.RequestJournal(path)
    j2.prime(log2)
    log2.record_progress("r0", {"a": [5, 6, 7]}, now=10.0)
    log2.complete("a", [5, 6, 7, 1], "eos", now=11.0)
    j2.sync(log2)
    j2.close()
    return j2


EVENTS = {"basic": _events_basic, "restart": _events_restart}


def _state(rec):
    return ({u: (i["request"].uid, list(i["request"].prompt),
                 i["request"].max_new_tokens, i["request"].seed, i["slo"],
                 i["deadline_s"], i["t_arrive"], list(i["emitted"]),
                 i["done"], i["reason"])
             for u, i in rec.entries.items()},
            rec.records, rec.corrupt, rec.gapped,
            sorted(rec.inflight, key=str), sorted(rec.completed, key=str))


@pytest.mark.parametrize("events", sorted(EVENTS))
def test_journal_files_are_byte_identical(tmp_path, events):
    files, stats = [], []
    for name, side in PACKAGES.items():
        path = str(tmp_path / f"{name}.jsonl")
        j = EVENTS[events](side, path)
        files.append(open(path, "rb").read())
        stats.append({k: v for k, v in j.stats.items() if k != "write_s"})
    assert files[0] == files[1] and files[1]
    assert stats[0] == stats[1]


@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")],
                         ids=["jax-written", "port-written"])
@pytest.mark.parametrize("events", sorted(EVENTS))
def test_each_package_recovers_the_other(tmp_path, events, writer, reader):
    path = str(tmp_path / "j.jsonl")
    EVENTS[events](PACKAGES[writer], path)
    got = PACKAGES[reader].fleet.recover_journal(path)
    own = PACKAGES[writer].fleet.recover_journal(path)
    assert _state(got) == _state(own)
    assert got.corrupt == 0 and got.gapped == 0
    assert isinstance(next(iter(got.entries.values()))["request"],
                      PACKAGES[reader].serve.Request)


def _tamper(path):
    lines = open(path, "rb").read().splitlines(keepends=True)
    tampered = lines[0].replace(b'"budget":6', b'"budget":7')
    assert tampered != lines[0]
    with open(path, "wb") as f:
        f.writelines([tampered] + lines[1:])


def _drop_first_delta(path):
    lines = open(path, "rb").read().splitlines(keepends=True)
    first = next(i for i, ln in enumerate(lines) if b'"progress"' in ln)
    with open(path, "wb") as f:
        f.writelines(lines[:first] + lines[first + 1:])


DAMAGE = {
    "crc-payload": lambda F, p: _tamper(p),
    "crc-bit": lambda F, p: F.flip_bit(p, byte_offset=30, bit=2),
    "torn-tail": lambda F, p: F.truncate_file(p, keep_bytes=(
        len(open(p, "rb").read()) - 7)),
    "half": lambda F, p: F.truncate_file(p),
    "gap": lambda F, p: _drop_first_delta(p),
    "removed": lambda F, p: F.remove_file(p),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_damage_detected_as_jax_detects_it(tmp_path, damage):
    """The same journal, damaged by each package's helper: equal bytes
    after the damage, equal recoveries from both readers."""
    files, states = [], []
    for name, side in PACKAGES.items():
        path = str(tmp_path / f"{name}.jsonl")
        log, j = side.fleet.RequestLog(), side.fleet.RequestJournal(path)
        _admit(side, log, j, "a")
        _admit(side, log, j, "b")
        log.record_progress("r0", {"a": [5, 6], "b": [1]}, now=2.0)
        j.sync(log)
        log.record_progress("r0", {"a": [5, 6, 7, 8]}, now=3.0)
        j.sync(log)
        j.close()
        DAMAGE[damage](side.faults, path)
        try:
            files.append(open(path, "rb").read())
        except FileNotFoundError:
            files.append(None)
        states.append([_state(s.fleet.recover_journal(path))
                       for s in PACKAGES.values()])
    assert files[0] == files[1]
    assert states[0][0] == states[0][1] == states[1][0] == states[1][1]
    entries, records, corrupt, gapped = states[1][1][:4]
    if damage == "gap":
        assert gapped == 1 and entries["a"][7] == []
    elif damage == "removed":
        assert entries == {} and records == 0
    else:
        assert corrupt == 1


def test_unjournalable_uid_and_logger(tmp_path):
    log = tfleet.RequestLog()
    j = tfleet.RequestJournal(str(tmp_path / "j.jsonl"))
    e = log.admit(tserve.Request(uid=("t", 1), prompt=[1, 2],
                                 max_new_tokens=2, seed=1),
                  slo="interactive", replica="r0", t_arrive=0.0)
    with pytest.raises(ValueError, match="uids must be str or int"):
        j.admit(e)
    # the logger is kept, as JAX's journal keeps it
    logger = object()
    assert tfleet.RequestJournal(str(tmp_path / "k.jsonl"),
                                 logger=logger).logger is logger
    assert jfleet.RequestJournal(str(tmp_path / "l.jsonl"),
                                 logger=logger).logger is logger
    assert tfleet.recover_journal(str(tmp_path / "none.jsonl")).entries == {}


# ---------------------------------------------------------------------------
# a fleet restart from the journal, over the tiny GPT
# ---------------------------------------------------------------------------

SIZES = dict(vocab_size=256, num_layers=2, hidden_size=64,
             num_attention_heads=4, max_position_embeddings=128)
PAGE, CHUNK, MAXP = 4, 8, 48
PPS = MAXP // PAGE


@pytest.fixture(scope="module")
def sides():
    original = apex_tpu._compat.shard_map

    def shard_map(f, mesh, in_specs, out_specs, check=True):
        return original(f, mesh, in_specs, out_specs, check=False)

    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(apex_tpu._compat, "shard_map", shard_map)
        mesh = parallel_state.initialize_model_parallel(
            devices=jax.devices()[:1])
        jm = JaxGPTModel(JaxGPTConfig(**SIZES, compute_dtype=jnp.float32,
                                      remat=False, attention_impl="xla"))
        rng = np.random.RandomState(3)
        params = jax.tree.map(
            lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32),
            jm.init(jax.random.PRNGKey(0)))
        tm = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                      device="cpu")
        tm.load_state_dict(convert.params_from_jax(params))
        kw = dict(num_layers=2, num_heads=4, head_dim=16,
                  num_pages=1 + 2 * PPS, page_size=PAGE, max_seqs=2,
                  pages_per_seq=PPS)
        jcfg = jkv.KVCacheConfig(dtype=jnp.float32, **kw)
        tcfg = tkv.KVCacheConfig(dtype=torch.float32, **kw)
        sampling = dict(temperature=0.9, top_k=20)
        jax_side = types.SimpleNamespace(
            kv=jkv, cfg=jcfg, pools=lambda: jkv.init_pools(jcfg),
            fns=jm.decode_fns(params, mesh, jcfg, max_prompt_len=MAXP,
                              prefill_chunk=CHUNK, **sampling),
            **vars(PACKAGES["jax"]))
        port_side = types.SimpleNamespace(
            kv=tkv, cfg=tcfg, pools=lambda: tkv.init_pools(tcfg, "cpu"),
            fns=tm.decode_fns(tcfg, max_prompt_len=MAXP,
                              prefill_chunk=CHUNK, **sampling),
            **vars(PACKAGES["port"]))
        yield jax_side, port_side
    parallel_state.destroy_model_parallel()
    assert apex_tpu._compat.shard_map is original


def _replicas(side):
    f = side.fns
    return [side.fleet.Replica(f"r{i}", side.serve.ContinuousBatcher(
        f.prefill, f.decode, side.kv.PagedKVCache(side.cfg), side.pools(),
        max_prompt_len=MAXP, harvest_every=2, chunk_fn=f.chunk,
        prefill_chunk=CHUNK, prefix_cache=True)) for i in range(2)]


def _reqs(side):
    rng = np.random.RandomState(31)
    return [side.serve.Request(
        uid=f"u{i}", prompt=[int(t) for t in
                             rng.randint(1, 256, (9 + (i % 3) * 5,))],
        max_new_tokens=6, seed=100 + i) for i in range(5)]


def _tokens(router):
    return {u: c.tokens for u, c in sorted(router.completions.items())}


def _serve_partway(side, path, steps=4):
    router = side.fleet.FleetRouter(
        _replicas(side), journal=side.fleet.RequestJournal(path))
    for r in _reqs(side):
        assert router.submit(r)
    for _ in range(steps):
        router.step()
    router.journal.close()
    assert router.pending > 0, "nothing in flight at the kill point"
    return dict(router.completions)


def _restart(side, path):
    rec = side.fleet.recover_journal(path)
    assert rec.corrupt == 0
    journal = side.fleet.RequestJournal(path)
    router = side.fleet.FleetRouter(_replicas(side), journal=journal)
    out = router.resume_from_journal(rec)
    router.drain()
    journal.close()
    return router, out


def test_restart_from_journal_matches_jax(sides, tmp_path):
    """Serve partway, abandon, recover and resume on fresh batchers: every
    seeded-sampled stream of the unkilled run, the completed-before-death
    ones from the journal, in both packages alike; a second recovery of
    the same path sees every stream done."""
    got = []
    for side in sides:
        ref = side.fleet.FleetRouter(_replicas(side))
        for r in _reqs(side):
            assert ref.submit(r)
        ref.drain()
        path = str(tmp_path / f"{side.serve.__name__}.jsonl")
        before = _serve_partway(side, path)
        router, out = _restart(side, path)
        assert out["resumed"] + out["completed"] == 5
        assert out["resumed"] >= 1
        assert _tokens(router) == _tokens(ref)
        for uid, c in before.items():
            assert router.completions[uid].tokens == c.tokens
            assert router.completions[uid].replica == "<journal>"
        rec2 = side.fleet.recover_journal(path)
        assert rec2.corrupt == 0 and rec2.gapped == 0
        assert {u: i["emitted"] for u, i in rec2.entries.items()} == \
            _tokens(ref)
        assert all(i["done"] for i in rec2.entries.values())
        # the records in order, but for the arrival times (each run's
        # clock) and the CRCs over them
        records = [{k: v for k, v in json.loads(line).items()
                    if k not in ("t", "crc")}
                   for line in open(path, "rb").read().splitlines()]
        got.append((out, _tokens(router), router.stats, records))
    assert got[0] == got[1]


def test_port_resumes_a_jax_written_journal(sides, tmp_path):
    jside, tside = sides
    path = str(tmp_path / "jax.jsonl")
    _serve_partway(jside, path)
    ref = tfleet.FleetRouter(_replicas(tside))
    for r in _reqs(tside):
        assert ref.submit(r)
    ref.drain()
    router, out = _restart(tside, path)
    assert out["resumed"] >= 1
    assert _tokens(router) == _tokens(ref)
    rec = jfleet.recover_journal(path)
    assert rec.corrupt == 0 and rec.gapped == 0
    assert {u: i["emitted"] for u, i in rec.entries.items()} == _tokens(ref)
