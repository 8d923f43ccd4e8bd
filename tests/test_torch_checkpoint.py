"""The port's checkpoint (``apex_tpu_torch.checkpoint``) and its native
flatten (``apex_tpu_torch.csrc``) against the JAX package's, on the CPU.

- For the same trees (fp32, bf16, fp16, int8/int32/int64, bool, 0-d
  scalars, ``None`` leaves, nested dicts, lists and tuples; the JAX side
  gets the numpy twin of each torch leaf), ``data.bin``, the manifest's
  ``leaves`` and ``data.bin``'s integrity record are byte for byte the
  JAX package's, with chunks small enough to make several.
- The port reads a JAX-written directory with ``target=`` and never
  unpickles its ``treedef.pkl``; without a target it refuses.
- Under each fault of ``resilience.faults`` (truncated, bit-flipped and
  removed files; failing writes and renames; SIGTERM mid-save) the port's
  ``verify`` names the same files as JAX's (the port's ``structure.json``
  where JAX has ``treedef.pkl``) and ``restore_latest_valid`` lands on the
  same step; the port's ``verify`` also judges JAX-written directories as
  JAX does.
- ``flatten`` / ``unflatten`` / ``plan_buckets`` equal their numpy plain
  versions and the JAX package's.
- The module works where ``ml_dtypes`` cannot be imported (a
  subprocess), and ``save_async`` snapshots before it returns: an
  in-place update right after it does not reach the file.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as jckpt
from apex_tpu import csrc as jcsrc
from apex_tpu.resilience import faults as jfaults
from apex_tpu_torch import checkpoint as tckpt
from apex_tpu_torch import csrc as tcsrc
from apex_tpu_torch.resilience import faults as tfaults

torch.set_num_threads(1)  # the suite's parallel workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _small_chunks_fast_retry(monkeypatch):
    monkeypatch.setenv("APEX_TPU_CKPT_CHUNK_BYTES", "64")
    monkeypatch.setenv("APEX_TPU_IO_RETRIES", "2")
    monkeypatch.setenv("APEX_TPU_IO_BACKOFF_BASE", "0.001")
    monkeypatch.setenv("APEX_TPU_IO_BACKOFF_MAX", "0.002")
    yield
    for mod in (tckpt, jckpt):
        try:
            mod.wait_pending_saves(timeout=30)
        except Exception:
            pass


def _np(t):
    """A torch leaf's numpy twin for the JAX side (bf16 as ml_dtypes)."""
    if not isinstance(t, torch.Tensor):
        return t
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    return _np(tree)


def _trees():
    rng = np.random.default_rng(0)

    def t(a, dtype=None):
        x = torch.from_numpy(np.asarray(a))
        return x if dtype is None else x.to(dtype)

    return {
        "fp32": {"w": t(rng.standard_normal((5, 7)).astype(np.float32))},
        "bf16": {"w": t(rng.standard_normal((3, 33)), torch.bfloat16),
                 "v": t(rng.standard_normal((4,)), torch.bfloat16)},
        "fp16": [t(rng.standard_normal((6, 2)).astype(np.float16)),
                 t(rng.standard_normal((9,)).astype(np.float32))],
        "ints": {"i8": t(rng.integers(-128, 127, (11,)).astype(np.int8)),
                 "i32": t(rng.integers(-9, 9, (2, 3)).astype(np.int32)),
                 "i64": t(rng.integers(-9, 9, (4,)).astype(np.int64)),
                 "u8": t(np.arange(5, dtype=np.uint8))},
        "bool_scalars": {"flag": t(np.array([True, False, True])),
                         "b0": t(np.array(True)), "f0": t(np.float32(2.5)),
                         "i0": t(np.int32(-7)), "py_f": 1.25, "py_i": 42,
                         "np_i": np.int64(3)},
        "nested_none": {"z": None, "a": [None, (t(np.ones(3, np.float32)),
                                                {"q": None,
                                                 "p": t(np.int32(1))}),
                                         []],
                        "m": {"y": (), "x": t(np.zeros((0, 4),
                                                       np.float32))}},
        "trainer_like": {
            "params": {"layers": {"w": t(rng.standard_normal((2, 4, 4)),
                                         torch.bfloat16)},
                       "emb": t(rng.standard_normal((8, 4)),
                                torch.bfloat16)},
            "opt": {"step": t(np.int32(5)),
                    "exp_avg": {"emb": t(np.zeros((8, 4), np.float32))}},
            "amp": {"loss_scaler0": {"loss_scale": 1.0,
                                     "growth_tracker": 0, "unskipped": 3}},
            "step": np.int64(9)},
    }


TREES = list(_trees())


def _leaves_eq(a, b):
    """Two restored trees equal leaf for leaf (values, dtypes, shapes)."""
    la, sa = tckpt.flatten_tree(a)
    lb, sb = tckpt.flatten_tree(b)
    assert sa == sb and len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = tckpt._as_tensor(x), tckpt._as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(-1).view(torch.uint8) if x.numel()
                           else x, y.view(-1).view(torch.uint8)
                           if y.numel() else y)


@pytest.mark.parametrize("name", TREES)
def test_bytes_equal_jax(name, tmp_path):
    tree = _trees()[name]
    jckpt.save(str(tmp_path / "j"), _to_jax(tree))
    tckpt.save(str(tmp_path / "t"), tree)
    jm = json.load(open(tmp_path / "j" / "manifest.json"))
    tm = json.load(open(tmp_path / "t" / "manifest.json"))
    assert tm["leaves"] == jm["leaves"]
    assert tm["integrity"]["files"]["data.bin"] == \
        jm["integrity"]["files"]["data.bin"]
    assert tm["integrity"]["chunk_bytes"] == jm["integrity"]["chunk_bytes"]
    assert (tmp_path / "t" / "data.bin").read_bytes() == \
        (tmp_path / "j" / "data.bin").read_bytes()
    assert sorted(os.listdir(tmp_path / "t")) == [
        "data.bin", "manifest.json", "structure.json"]
    # the port's own round trip keeps the structure (tuples, None, [])
    back = tckpt.restore(str(tmp_path / "t"), verify_integrity=True)
    _leaves_eq(back, tree)
    assert tckpt.flatten_tree(back)[1] == tckpt.flatten_tree(tree)[1]


@pytest.mark.parametrize("name", TREES)
def test_restores_a_jax_written_checkpoint_with_target(name, tmp_path,
                                                       monkeypatch):
    tree = _trees()[name]
    path = str(tmp_path / "j")
    jckpt.save(path, _to_jax(tree))

    def no_unpickle(*a, **k):
        raise AssertionError("a PyTreeDef was unpickled")

    monkeypatch.setattr(pickle, "loads", no_unpickle)
    monkeypatch.setattr(pickle, "load", no_unpickle)
    got = tckpt.restore(path, target=tree, verify_integrity=True)
    _leaves_eq(got, tree)
    assert tckpt.verify(path) == []
    with pytest.raises(ValueError, match="target="):
        tckpt.restore(path)
    bad = dict(tree, extra=torch.zeros(1)) if isinstance(tree, dict) \
        else tree + [torch.zeros(1)]
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore(path, target=bad)


def _save_three(mod, root, tree):
    for s in (1, 2, 3):
        mod.save_step(root, s, tree)


def _fault(kind, pkg, root, tree):
    """Break the newest step (or leave it unwritten) as ``kind`` says,
    through the package's own fault harness."""
    ck, faults = pkg
    step3 = os.path.join(root, "step_3")
    struct = "treedef.pkl" if ck is jckpt else "structure.json"
    if kind == "truncate_data":
        faults.truncate_file(os.path.join(step3, "data.bin"))
    elif kind == "flip_data":
        faults.flip_bit(os.path.join(step3, "data.bin"), 70, 3)
    elif kind == "flip_structure":
        faults.flip_bit(os.path.join(step3, struct), 2, 1)
    elif kind == "flip_manifest":      # the closing brace: unparseable
        man = os.path.join(step3, "manifest.json")
        faults.flip_bit(man, os.path.getsize(man) - 1, 0)
    elif kind == "remove_data":
        faults.remove_file(os.path.join(step3, "data.bin"))
    elif kind == "remove_structure":
        faults.remove_file(os.path.join(step3, struct))
    elif kind == "remove_manifest":
        faults.remove_file(os.path.join(step3, "manifest.json"))
    elif kind == "failing_writes":
        with faults.failing_writes(forever=True, path_substr="step_4"):
            with pytest.raises(faults.InjectedIOError):
                ck.save_step(root, 4, tree)
    elif kind == "failing_renames":
        with faults.failing_renames(forever=True):
            with pytest.raises(faults.InjectedIOError):
                ck.save_step(root, 4, tree)
    elif kind == "sigterm_on_write":
        got = []
        prev = signal.signal(signal.SIGTERM, lambda *a: got.append(1))
        try:
            with faults.sigterm_on_write(2):
                ck.save_step(root, 4, tree)
        finally:
            signal.signal(signal.SIGTERM, prev)
        assert got == [1]


FAULTS = ["truncate_data", "flip_data", "flip_structure", "flip_manifest",
          "remove_data", "remove_structure", "remove_manifest",
          "failing_writes", "failing_renames", "sigterm_on_write"]


def _judge(ck, root, target=None):
    names = sorted(os.listdir(root))
    verdicts = {d: sorted(ck.verify(os.path.join(root, d)))
                for d in names if not d.endswith((".tmp", ".old"))}
    _, step = ck.restore_latest_valid(root, target=target)
    return names, verdicts, step, ck.latest_valid_step(root)


def _portable(judged):
    """JAX's structure file named as the port's."""
    names, verdicts, step, valid = judged
    return names, {d: sorted("structure.json" if f == "treedef.pkl" else f
                             for f in v)
                   for d, v in verdicts.items()}, step, valid


@pytest.mark.parametrize("kind", FAULTS)
def test_verify_and_fallback_match_jax_under_faults(kind, tmp_path):
    tree = _trees()["trainer_like"]
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    _save_three(jckpt, jroot, _to_jax(tree))
    _save_three(tckpt, troot, tree)
    _fault(kind, (jckpt, jfaults), jroot, _to_jax(tree))
    _fault(kind, (tckpt, tfaults), troot, tree)
    j = _judge(jckpt, jroot)
    assert _judge(tckpt, troot) == _portable(j)
    # the port judges the JAX-written directories as JAX does
    assert _judge(tckpt, jroot, target=tree) == j


def test_save_async_snapshots_before_returning(tmp_path, monkeypatch):
    """An in-place update right after ``save_async`` returns (the port's
    optimizers update in place) does not reach the file, even while the
    writer thread is held back."""
    import threading

    gate = threading.Event()
    orig = tckpt._open

    def held_open(file, mode="r", *a, **k):
        gate.wait(5)
        return orig(file, mode, *a, **k)

    monkeypatch.setattr(tckpt, "_open", held_open)
    w = torch.arange(12, dtype=torch.float32)
    h = tckpt.save_async(str(tmp_path / "a"), {"w": w, "n": 3})
    w.add_(100.0)                       # the next "step", in place
    gate.set()
    h.result(timeout=30)
    tckpt.wait_pending_saves(timeout=30)
    got = tckpt.restore(str(tmp_path / "a"), verify_integrity=True)
    assert torch.equal(got["w"], torch.arange(12, dtype=torch.float32))
    assert int(got["n"]) == 3 and got["n"].dtype == torch.int64


@pytest.mark.parametrize("sizes", [[], [3], [1, 7, 0, 12], [64] * 9])
def test_flatten_matches_plain_and_jax(sizes):
    rng = np.random.default_rng(len(sizes))
    dtypes = [torch.float32, torch.bfloat16, torch.int8, torch.bool,
              torch.float16, torch.int64]
    ts, arrs = [], []
    for i, n in enumerate(sizes):
        dt = dtypes[i % len(dtypes)]
        x = torch.from_numpy(rng.standard_normal(n)).to(dt) \
            if dt != torch.bool else torch.from_numpy(rng.random(n) > 0.5)
        ts.append(x.reshape(-1, 1) if n % 2 == 0 and n else x)
        arrs.append(_np(ts[-1]))
    flat = tcsrc.flatten(ts)
    assert flat.dtype == torch.uint8
    np.testing.assert_array_equal(flat.numpy(), tcsrc.flatten_plain(ts))
    np.testing.assert_array_equal(flat.numpy(), jcsrc.flatten(arrs))
    shapes = [tuple(t.shape) for t in ts]
    dts = [t.dtype for t in ts]
    for back in (tcsrc.unflatten(flat, shapes, dts),
                 tcsrc.unflatten_plain(flat.numpy(), shapes, dts)):
        assert all(torch.equal(a, b) for a, b in zip(ts, back))
    nbytes = [t.numel() * t.element_size() for t in ts]
    for cap in (1, 16, 100):
        got = tcsrc.plan_buckets(nbytes, cap).numpy()
        np.testing.assert_array_equal(got,
                                      tcsrc.plan_buckets_plain(nbytes, cap))
        np.testing.assert_array_equal(got, jcsrc.plan_buckets(nbytes, cap))
    with pytest.raises(ValueError, match="describe"):
        tcsrc.unflatten(flat, shapes + [(1,)], dts + [torch.float32])


def test_works_without_ml_dtypes(tmp_path):
    """A bf16 tree saved, verified and restored in a process where
    ``ml_dtypes`` cannot be imported (the card's installation has none),
    byte-equal to the JAX package's file written here."""
    tree = {"w": torch.linspace(-2, 2, 20).to(torch.bfloat16),
            "s": torch.tensor(7, dtype=torch.int32)}
    jckpt.save(str(tmp_path / "j"), _to_jax(tree))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None          # import raises
        import torch
        from apex_tpu_torch import checkpoint as ck
        tree = {{"w": torch.linspace(-2, 2, 20).to(torch.bfloat16),
                "s": torch.tensor(7, dtype=torch.int32)}}
        ck.save({str(tmp_path / "t")!r}, tree)
        assert ck.verify({str(tmp_path / "t")!r}) == []
        back = ck.restore({str(tmp_path / "t")!r}, verify_integrity=True)
        assert torch.equal(back["w"], tree["w"])
        assert "ml_dtypes" not in [m for m, v in sys.modules.items() if v]
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"
    assert (tmp_path / "t" / "data.bin").read_bytes() == \
        (tmp_path / "j" / "data.bin").read_bytes()
