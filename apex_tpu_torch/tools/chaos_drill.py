"""Chaos drill: scripted fault schedules against a serving fleet, scored
as a zero-loss / token-identity / deadline ledger.

The port's twin of the root ``tools/chaos_drill.py`` over the port's
``fleet`` (router, journal, failover), ``resilience.faults``,
``checkpoint`` and :mod:`apex_tpu_torch.tools.load_gen`.  Its three
promises:

1. **zero loss**: every admitted request ends in a completion or a clean
   per-request terminal (``deadline``), never a hang or a dropped uid;
2. **token identity**: every completed stream equals an unfaulted run of
   the same trace (a deadline terminal is a committed prefix of it);
3. **bounded overhead**: the request journal stays under 2% of the
   serving wall, from the journal's own write clock.

The default mode runs the in-process matrix (:func:`run_matrix`): a clean
replay of a ``load_gen`` trace, then the same trace with a replica killed
mid-serve, repeated non-finite faults to quarantine, one transient
fault, brownout under queue pressure, a deadline/hedge scenario on an
injected clock, and a journaled replay scored for overhead; the ledger is
one ``CHAOS {...}`` line with the JAX tool's keys, exit 0 iff every
promise held.  Its world (:class:`World`) is the JAX tool's tiny GPT on
the CPU by default; ``chip_smoke.py`` builds one at the flagship's width
on the card.

``--subprocess`` runs the restart drill across a real process boundary:
a child serves over an int8 weight pool with a durable journal and is
SIGKILLed mid-serve; the next life restores the parameters from the
checkpoint, re-derives the pool (held bit-identical to the one the first
life served), replays the journal and resumes every request in flight;
the drill passes iff the streams equal a never-killed child's token for
token with zero losses.

    python -m apex_tpu_torch.tools.chaos_drill --device cpu
    python -m apex_tpu_torch.tools.chaos_drill --device cpu --subprocess --root /tmp/drill
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the JAX tool's world: a tiny fp32 GPT, pages of 4, chunks of 4
SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=96)
#: on the card the kernels take head dims of 64 and 128: the same world
#: with 4 heads of 64
GPU_SIZES = dict(SIZES, hidden_size=256)
#: the JAX tool's trace (``_mk_trace``)
TRACE = dict(n_requests=24, seed=11, mean_gap=0.5, burstiness=4.0,
             prompt_len=(10, 26), new_tokens=(4, 8), interactive_frac=0.5,
             cohorts=2, cohort_frac=0.7, prefix_len=8)


def _log(msg: str) -> None:
    print(f"[chaos-drill] {msg}", flush=True)


# --------------------------------------------------------------- world
@dataclasses.dataclass
class World:
    """One serving world: a model, its decode functions over a paged
    cache of ``page`` tokens a page and ``maxp`` prompt tokens, and the
    replicas' geometry (2 slots each, ``1 + pages_factor * pps``
    pages)."""

    model: Any
    page: int = 4
    chunk: int = 4
    maxp: int = 48
    new: int = 12
    slots: int = 2
    pages_factor: int = 4

    def __post_init__(self):
        from apex_tpu_torch.serving import KVCacheConfig

        c = self.model.config
        pps = -(-(self.maxp + self.new) // self.page)
        self.ccfg = KVCacheConfig(
            num_layers=c.num_layers, num_heads=c.num_attention_heads,
            head_dim=c.head_dim, num_pages=1 + self.pages_factor * pps,
            page_size=self.page, max_seqs=self.slots, pages_per_seq=pps,
            dtype=c.compute_dtype)
        self.fns = self.model.decode_fns(self.ccfg,
                                         max_prompt_len=self.maxp,
                                         prefill_chunk=self.chunk)
        self._pools: Dict[str, Dict[str, torch.Tensor]] = {}

    def replicas(self, n: int = 2) -> list:
        """Fresh batchers over ``n`` replicas' pools (made once a name,
        zeroed by a fresh cache's page accounting), prefix caching on."""
        from apex_tpu_torch.fleet import Replica
        from apex_tpu_torch.serving import (
            ContinuousBatcher,
            PagedKVCache,
            init_pools,
        )

        out = []
        for i in range(n):
            name = f"r{i}"
            if name not in self._pools:
                self._pools[name] = init_pools(self.ccfg, self.model.device)
            out.append(Replica(name, ContinuousBatcher(
                self.fns.prefill, self.fns.decode, PagedKVCache(self.ccfg),
                self._pools[name], max_prompt_len=self.maxp,
                harvest_every=2, chunk_fn=self.fns.chunk,
                prefill_chunk=self.chunk, prefix_cache=True)))
        return out


def tiny_model(device="cpu", state: Optional[Dict] = None, seed: int = 7):
    """The JAX tool's GPT (vocab 64, 2 layers, hidden 32, 4 heads, fp32;
    hidden 256 on a CUDA device, :data:`GPU_SIZES`): seeded, or from a
    state dict (``convert.params_from_jax`` of the JAX tool's parameters,
    say)."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.utils.platform import resolve_device

    sizes = GPU_SIZES if resolve_device(device).type == "cuda" else SIZES
    model = GPTModel(GPTConfig(**sizes, compute_dtype=torch.float32),
                     device=device, seed=seed)
    if state is not None:
        model.load_state_dict(state)
    return model


def make_trace(vocab_size: int, **over):
    from apex_tpu_torch.tools.load_gen import make_trace as mk

    return mk(vocab_size=vocab_size, **dict(TRACE, **over))


def _streams(router) -> Dict[str, List[int]]:
    return {u: list(c.tokens) for u, c in router.completions.items()}


def _check_identity(name, streams, ref, *, allow_prefix=()):
    """Every stream must equal the reference (or be a committed prefix
    for uids in ``allow_prefix``).  Returns a list of violations."""
    bad = []
    for uid, toks in streams.items():
        want = ref.get(uid)
        if want is None:
            bad.append(f"{name}: {uid} has no reference stream")
        elif toks != want and not (
                uid in allow_prefix and toks == want[:len(toks)]):
            bad.append(f"{name}: {uid} diverged "
                       f"(got {len(toks)} toks, want {len(want)})")
    return bad


# ------------------------------------------------------- in-process mode
def run_matrix(world: Optional[World] = None, trace=None,
               healthy: Optional[Callable] = None) -> Dict:
    """The chaos matrix over ``world`` (the tiny CPU world by default)
    and ``trace`` (:data:`TRACE` at the world's vocabulary): returns the
    ledger (JAX's keys) with ``problems``, the list of broken promises
    (empty: the drill passed).  ``healthy(label, router)``, when given,
    is called after each unfaulted run (``chip_smoke.py`` checks there
    that no replica faulted)."""
    from apex_tpu_torch.fleet import (
        BrownoutPolicy,
        FleetPolicy,
        FleetRouter,
        RequestJournal,
        SLOClass,
    )
    from apex_tpu_torch.resilience import faults
    from apex_tpu_torch.serving import Request
    from apex_tpu_torch.tools.load_gen import replay, summarize_trace

    world = world or World(tiny_model())
    trace = trace or make_trace(world.model.config.vocab_size)
    n_req = len(trace)
    problems: List[str] = []
    ledger: Dict[str, Any] = {"requests": n_req, "scenarios": {}}

    def fleet(policy=None, **kw):
        return FleetRouter(world.replicas(), policy, **kw)

    # ---- reference: the unfaulted truth ----------------------------
    t0 = time.perf_counter()
    ref_router = fleet()
    recs = replay(ref_router, trace)
    ref_wall = time.perf_counter() - t0
    ref = _streams(ref_router)
    s = summarize_trace(recs)
    if healthy is not None:
        healthy("chaos reference", ref_router)
    if s["lost"] or s["completed"] != n_req:
        problems.append(f"reference run lost requests: {s}")
    ledger["scenarios"]["reference"] = {
        "completed": s["completed"], "wall_s": round(ref_wall, 3)}
    _log(f"reference: {s['completed']}/{n_req} completed "
         f"in {ref_wall:.2f}s")

    # ---- scenario: replica killed mid-serve ------------------------
    r = fleet()
    r.replicas[0].fail_after(2)
    s = summarize_trace(replay(r, trace))
    problems += _check_identity("kill", _streams(r), ref)
    if s["lost"] or s["completed"] != n_req:
        problems.append(f"kill scenario lost requests: {s}")
    if s["migrated"] < 1:
        problems.append("kill scenario migrated nothing")
    ledger["scenarios"]["replica_kill"] = {
        "completed": s["completed"], "migrated": s["migrated"]}
    _log(f"replica_kill: {s['completed']}/{n_req} completed, "
         f"{s['migrated']} migrated")

    # ---- scenario: repeated non-finite faults -> quarantine --------
    r = fleet(FleetPolicy(max_replica_faults=2))
    with faults.nonfinite_logits(r.replicas[0].batcher, nth=3,
                                 forever=True):
        s = summarize_trace(replay(r, trace))
    problems += _check_identity("quarantine", _streams(r), ref)
    if s["lost"] or s["completed"] != n_req:
        problems.append(f"quarantine scenario lost requests: {s}")
    if r.replicas[0].quarantined != "faults":
        problems.append("faulting replica was not quarantined")
    ledger["scenarios"]["nonfinite_quarantine"] = {
        "completed": s["completed"],
        "quarantined": r.replicas[0].quarantined,
        "replica_faults": r.stats["replica_faults"]}
    _log(f"nonfinite_quarantine: {s['completed']}/{n_req} completed, "
         f"r0 quarantined={r.replicas[0].quarantined}")

    # ---- scenario: one transient fault heals without quarantine ----
    r = fleet()
    with faults.failing_windows(r.replicas[0].batcher, nth=2, count=1):
        s = summarize_trace(replay(r, trace))
    problems += _check_identity("transient", _streams(r), ref)
    if s["lost"] or s["completed"] != n_req:
        problems.append(f"transient scenario lost requests: {s}")
    if r.stats["quarantined"]:
        problems.append("transient fault wrongly quarantined a replica")
    ledger["scenarios"]["transient_fault"] = {
        "completed": s["completed"],
        "replica_faults": r.stats["replica_faults"]}
    _log(f"transient_fault: {s['completed']}/{n_req} completed, "
         f"no quarantine")

    # ---- scenario: brownout under queue pressure -------------------
    r = fleet(FleetPolicy(brownout=BrownoutPolicy(
        page_frac=(0.0, 0.0, 0.0), queue_depth=(3, 5, 8))))
    s = summarize_trace(replay(r, trace))
    problems += _check_identity("brownout", _streams(r), ref)
    if s["lost"]:
        problems.append(f"brownout scenario lost requests: {s}")
    if s["completed"] + s["rejected"] != n_req:
        problems.append(f"brownout ledger does not balance: {s}")
    if r.stats["brownout_transitions"] < 1:
        problems.append("queue pressure never tripped the brownout "
                        "ladder")
    ledger["scenarios"]["brownout"] = {
        "completed": s["completed"], "rejected": s["rejected"],
        "transitions": r.stats["brownout_transitions"]}
    _log(f"brownout: {s['completed']} completed + {s['rejected']} shed, "
         f"{r.stats['brownout_transitions']} transitions")

    # ---- scenario: deadlines + hedging on an injected clock --------
    # admission first: with a 1 s/step floor a 12-token request can never
    # meet a 3 s deadline: rejected with its own reason, not admitted
    ra = FleetRouter(world.replicas(), FleetPolicy(
        classes=(SLOClass("interactive", 0, deadline_s=3.0),
                 SLOClass("batch", 1)),
        step_floor_s=1.0))
    if ra.submit(Request(uid="x", prompt=[1] * 8, max_new_tokens=12,
                         seed=3)):
        problems.append("unmeetable deadline was admitted")
    if ra.rejected.get("x") != "deadline_unmeetable":
        problems.append(f"wrong rejection reason for unmeetable "
                        f"deadline: {ra.rejected.get('x')}")
    # then misses, retries and hedges on a tick clock (6 requests onto 4
    # slots queue past their deadline)
    clk = [0.0]
    policy = FleetPolicy(
        classes=(SLOClass("interactive", 0, deadline_s=3.0,
                          max_retries=8, hedge_after_s=2.0),
                 SLOClass("batch", 1, deadline_s=40.0)))
    r = FleetRouter(world.replicas(), policy, clock=lambda: clk[0])
    dreqs = [it.request for it in trace[:6]]
    for q in dreqs:
        r.submit(q, "interactive")
    while r.pending:
        r.step()
        clk[0] += 1.0
        if clk[0] > 300:
            problems.append("deadline/hedge scenario livelocked")
            break
    dref = {u: ref[u] for u in (q.uid for q in dreqs)}
    dead = [u for u, c in r.completions.items() if c.reason == "deadline"]
    problems += _check_identity("deadline", _streams(r), dref,
                                allow_prefix=set(dead))
    if len(r.completions) != len(dreqs):
        problems.append("deadline scenario lost requests")
    ledger["scenarios"]["deadline_hedge"] = {
        "completed": len(r.completions),
        "deadline_misses": r.stats["deadline_misses"],
        "retries": r.stats["deadline_retries"],
        "terminal_deadline": len(dead),
        "hedges": r.stats["hedges"],
        "hedge_wins": r.stats["hedge_wins"],
        "hedge_losses": r.stats["hedge_losses"],
        "rejected_unmeetable": 1}
    _log(f"deadline_hedge: {r.stats['deadline_misses']} misses, "
         f"{r.stats['deadline_retries']} retries, "
         f"{r.stats['hedges']} hedges ({len(dead)} terminal)")

    # ---- journal overhead: < 2% of the serving wall ----------------
    with tempfile.TemporaryDirectory() as td:
        journal = RequestJournal(os.path.join(td, "journal.jsonl"))
        r = fleet(journal=journal)
        t0 = time.perf_counter()
        s = summarize_trace(replay(r, trace))
        wall = time.perf_counter() - t0
        frac = journal.stats["write_s"] / max(wall, 1e-9)
        problems += _check_identity("journaled", _streams(r), ref)
        if s["lost"] or s["completed"] != n_req:
            problems.append(f"journaled run lost requests: {s}")
        if frac >= 0.02:
            problems.append(
                f"journal overhead {frac:.2%} >= 2% of serving time")
        ledger["scenarios"]["journal_overhead"] = {
            "write_s": round(journal.stats["write_s"], 5),
            "wall_s": round(wall, 3),
            "frac": round(frac, 5),
            "appends": journal.stats["appends"],
            "records": journal.stats["records"]}
        journal.close()
    _log(f"journal overhead: {frac:.3%} of serving wall "
         f"({journal.stats['appends']} appends, "
         f"{journal.stats['records']} records)")

    ledger["token_identical"] = not any("diverged" in p for p in problems)
    ledger["zero_loss"] = not any("lost" in p for p in problems)
    ledger["problems"] = problems
    return ledger


def print_ledger(ledger: Dict) -> int:
    """Print the ``CHAOS {...}`` line (JAX's keys) and the verdict;
    returns the exit code."""
    problems = ledger.get("problems", [])
    print("CHAOS " + json.dumps({k: v for k, v in ledger.items()
                                 if k != "problems"}), flush=True)
    if problems:
        for p in problems:
            _log(f"FAIL: {p}")
        return 1
    _log("chaos drill PASSED")
    return 0


# ------------------------------------------------------ subprocess mode
def drill_requests(vocab_size: int = 64):
    """The restart drill's fixed requests: both child legs derive the
    same ones from the same seeds (greedy and seeded sampling mixed, so
    the key schedule's replay is proven, not only argmax)."""
    from apex_tpu_torch.serving import Request

    rng = np.random.RandomState(23)
    reqs = []
    for i in range(8):
        plen = 8 + int(rng.randint(0, 12))
        prompt = [int(t) for t in rng.randint(1, vocab_size, (plen,))]
        reqs.append(Request(
            uid=f"d{i}", prompt=prompt, max_new_tokens=10,
            seed=None if i % 2 == 0 else 1000 + i))
    return reqs


def _pool_state(qmodel) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in qmodel.state_dict().items()}


def quantized_world(root: str, *, restore: bool, device="cpu",
                    state: Optional[Dict] = None) -> World:
    """The drill's world over an int8 weight pool.  The first life (and
    the reference) checkpoints the parameters (seeded, or ``state``) and
    the pool; the second restores the parameters, re-derives the pool,
    and holds it bit-identical to the one the first life served
    (``QPOOL_IDENTICAL`` on stdout)."""
    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.models.gpt import quantize_gpt_weights

    ck_params = os.path.join(root, "ckpt_params")
    ck_qpool = os.path.join(root, "ckpt_qpool")
    if restore:
        state = ckpt.restore(ck_params)
        model = tiny_model(device, {k: torch.as_tensor(np.asarray(v))
                                    for k, v in state.items()})
        qmodel = quantize_gpt_weights(model, "int8", block_size=32)
        saved = ckpt.restore(ck_qpool)
        mine = _pool_state(qmodel)
        if set(mine) != set(saved) or not all(
                np.array_equal(mine[k].numpy(), np.asarray(saved[k]))
                for k in mine):
            raise AssertionError(
                "re-derived quantized pool is not bit-identical to the "
                "pool the first life served")
        print("QPOOL_IDENTICAL", flush=True)
    else:
        model = tiny_model(device, state)
        ckpt.save(ck_params, {k: v.detach().cpu()
                              for k, v in model.state_dict().items()})
        qmodel = quantize_gpt_weights(model, "int8", block_size=32)
        ckpt.save(ck_qpool, _pool_state(qmodel))
    return World(qmodel)


def run_child(root: str, leg: str, device: str) -> int:
    from apex_tpu_torch.fleet import (
        FleetRouter,
        RequestJournal,
        recover_journal,
    )

    world = quantized_world(root, restore=leg == "resume", device=device)
    reqs = drill_requests()
    if leg == "ref":
        router = FleetRouter(world.replicas())
        for q in reqs:
            if not router.submit(q):
                raise RuntimeError(f"reference child rejected {q.uid}")
        router.drain()
        with open(os.path.join(root, "streams_ref.json"), "w") as f:
            json.dump(_streams(router), f)
        print("DONE", flush=True)
        return 0
    if leg == "serve":
        journal = RequestJournal(os.path.join(root, "journal.jsonl"))
        router = FleetRouter(world.replicas(), journal=journal)
        for q in reqs:
            if not router.submit(q):
                raise RuntimeError(f"serving child rejected {q.uid}")
        step = 0
        while router.pending:
            router.step()
            step += 1
            print(f"WINDOW {step} pending {router.pending}", flush=True)
        print("DONE", flush=True)       # the parent should have killed us
        return 0
    if leg == "resume":
        path = os.path.join(root, "journal.jsonl")
        rec = recover_journal(path)
        router = FleetRouter(world.replicas(), journal=RequestJournal(path))
        out = router.resume_from_journal(rec)
        print("REPLAYED " + json.dumps(out), flush=True)
        router.drain()
        with open(os.path.join(root, "streams_resumed.json"), "w") as f:
            json.dump(_streams(router), f)
        print("DONE", flush=True)
        return 0
    raise SystemExit(f"unknown child leg {leg!r}")


def _spawn(root: str, leg: str, device: str):
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.tools.chaos_drill",
         "--child", leg, "--root", root, "--device", device],
        stdout=subprocess.PIPE, text=True, bufsize=1, env=env, cwd=_REPO)


def run_restart_drill(root: str, kill_after_windows: int,
                      device: str = "cpu") -> Dict:
    """The SIGKILL restart drill: returns its ledger (JAX's keys) with
    ``problems``."""
    if os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(root)
    problems: List[str] = []

    _log("leg 0: reference serve (and checkpoint the weight pools)")
    child = _spawn(root, "ref", device)
    out, _ = child.communicate(timeout=600)
    if child.returncode != 0 or "DONE" not in out:
        sys.stdout.write(out or "")
        return {"mode": "restart", "problems": [
            f"reference child exited {child.returncode}"]}
    with open(os.path.join(root, "streams_ref.json")) as f:
        ref = json.load(f)
    _log(f"reference streams: {len(ref)} requests")

    _log(f"leg 1: serve, SIGKILL after {kill_after_windows} windows")
    child = _spawn(root, "serve", device)
    windows = 0
    try:
        for line in child.stdout:
            line = line.strip()
            m = re.match(r"WINDOW (\d+) pending (\d+)", line)
            if m:
                windows = int(m.group(1))
                if windows >= kill_after_windows and int(m.group(2)) > 0:
                    _log(f"SIGKILL at window {windows} "
                         f"({m.group(2)} requests in flight)")
                    child.send_signal(signal.SIGKILL)
                    break
            elif line == "DONE":
                return {"mode": "restart", "problems": [
                    "serve child drained before the kill window: raise "
                    "the request count"]}
    finally:
        child.wait(timeout=60)
        child.stdout.close()

    _log("leg 2: restore checkpoint, replay journal, resume")
    child = _spawn(root, "resume", device)
    out, _ = child.communicate(timeout=600)
    if child.returncode != 0 or "DONE" not in out:
        sys.stdout.write(out or "")
        return {"mode": "restart", "problems": [
            f"resume child exited {child.returncode}"]}
    if "QPOOL_IDENTICAL" not in out:
        problems.append("resume child did not verify the quantized pool")
    m = re.search(r"^REPLAYED (\{.*\})$", out, re.M)
    replayed = json.loads(m.group(1)) if m else {}
    with open(os.path.join(root, "streams_resumed.json")) as f:
        resumed = json.load(f)
    if set(resumed) != set(ref):
        problems.append(
            f"zero-loss violated: reference has {sorted(ref)}, "
            f"resumed life has {sorted(resumed)}")
    for uid in sorted(set(resumed) & set(ref)):
        if resumed[uid] != ref[uid]:
            problems.append(f"token identity violated for {uid}")
    if replayed.get("resumed", 0) < 1:
        problems.append(
            f"the kill landed with nothing in flight ({replayed}): the "
            "drill proved nothing; lower --kill-after-windows")
    return {
        "mode": "restart", "requests": len(ref),
        "killed_at_window": windows, "replayed": replayed,
        "token_identical": not any("identity" in p for p in problems),
        "zero_loss": not any("zero-loss" in p for p in problems),
        "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--subprocess", action="store_true",
                    help="run the SIGKILL restart drill")
    ap.add_argument("--root", default=None,
                    help="the restart drill's directory (default: a new "
                         "temporary one)")
    ap.add_argument("--kill-after-windows", type=int, default=7,
                    help="serve windows before the SIGKILL (late enough "
                         "that some requests have completed)")
    ap.add_argument("--device", default=None,
                    help="the world's device (default: the GPU)")
    ap.add_argument("--child", choices=("ref", "serve", "resume"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from apex_tpu_torch.utils.platform import resolve_device

    device = str(resolve_device(args.device))
    if args.child:
        return run_child(args.root, args.child, device)
    if args.subprocess:
        root = args.root or tempfile.mkdtemp(prefix="chaos_drill_")
        ledger = run_restart_drill(root, args.kill_after_windows, device)
        code = print_ledger(ledger)
        if code == 0:
            rep = ledger["replayed"]
            _log(f"restart drill: {rep.get('completed', 0)} completed + "
                 f"{rep.get('resumed', 0)} in-flight recovered, all "
                 "token-identical")
        return code
    return print_ledger(run_matrix(World(tiny_model(device))))


if __name__ == "__main__":
    sys.exit(main())
