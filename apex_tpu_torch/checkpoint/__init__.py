"""Checkpoint and resume of whole training states, in the JAX package's
on-disk format.

The port's counterpart of ``apex_tpu/checkpoint/__init__.py``.  A state
is a tree of dicts, lists, tuples, ``None`` and leaves (tensors on the
host or the card, numpy arrays and scalars, Python numbers); it is
written as

- ``data.bin``: every leaf's bytes, in the JAX package's leaf order (dict
  keys sorted, as ``jax.tree_util`` flattens; ``None`` holds no leaf),
  through the native flatten of :mod:`apex_tpu_torch.csrc`;
- ``manifest.json``: each leaf's shape and dtype name (numpy's names,
  ``bfloat16`` included) and the ``integrity`` record, chunked CRC32s of
  every payload file (``APEX_TPU_CKPT_CHUNK_BYTES`` a chunk);
- ``structure.json``: the tree's structure, in a format of the port's own
  (listed in the integrity record).  The JAX package pickles a
  ``PyTreeDef`` there instead (``treedef.pkl``), which the port can
  neither write nor read: a JAX-written checkpoint restores here only with
  ``target=``, whose structure stands in for it, and its ``treedef.pkl``
  is checksummed but never unpickled.

So for the same tree ``data.bin``, the manifest's ``leaves`` and
``data.bin``'s integrity record are byte for byte the JAX package's.
Dtypes are mapped by name to torch dtypes and bytes are moved as they
are: nothing here needs ``ml_dtypes``.

Integrity and fault tolerance are the JAX module's: atomic visibility
through ``<path>.tmp`` and a rename, an overwritten checkpoint parked at
``<path>.old`` until the new one lands (:func:`_recover_parked` heals a
crash in between), :func:`verify` naming exactly the files that fail,
the blob's length checked against the manifest before it is split,
:func:`restore_latest_valid` walking back past corrupt steps, and the
write paths under the bounded retry of
:mod:`apex_tpu_torch.resilience.retry`.

Snapshots: the port's optimizers update parameters, moments and masters
IN PLACE, so a save must hold its own copy before the next step runs.
Leaves on the card are copied straight into their slices of one pinned
host buffer (the ``data.bin`` image) and the stream is synchronised once;
host leaves are flattened into the same buffer.  :func:`save_async`
returns only after that snapshot, and leaves the checksums and the file
writes to a thread.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import csrc
from apex_tpu_torch.resilience.retry import retry_io
from apex_tpu_torch.telemetry import events as _events

__all__ = ["save", "restore", "latest_step", "save_step", "restore_step",
           "save_async", "wait_pending_saves", "verify",
           "restore_latest_valid", "latest_valid_step",
           "CheckpointCorruptError", "flatten_tree", "unflatten_tree"]

logger = logging.getLogger("apex_tpu_torch.checkpoint")

_MANIFEST = "manifest.json"
_DATA = "data.bin"
#: the port's structure file
_STRUCTURE = "structure.json"
#: the JAX package's pickled PyTreeDef (checksummed, never unpickled)
_TREEDEF = "treedef.pkl"

# I/O seams: the fault-injection harness (apex_tpu_torch.resilience.
# faults) swaps these to fail / signal the Nth write.  The production
# path is identical to calling the builtins.
_open = open
_replace = os.replace

# checksum streaming granularity; env-tunable so tests exercise the
# multi-chunk path with tiny blobs
_ENV_CHUNK = "APEX_TPU_CKPT_CHUNK_BYTES"
_DEFAULT_CHUNK = 4 * 1024 * 1024

#: numpy dtype names (as the JAX package records them) -> torch dtypes
_DTYPES: Dict[str, torch.dtype] = {
    name: getattr(torch, attr) for name, attr in (
        ("float64", "float64"), ("float32", "float32"),
        ("float16", "float16"), ("bfloat16", "bfloat16"),
        ("int64", "int64"), ("int32", "int32"), ("int16", "int16"),
        ("int8", "int8"), ("uint8", "uint8"), ("uint16", "uint16"),
        ("uint32", "uint32"), ("uint64", "uint64"), ("bool", "bool"),
        ("complex64", "complex64"), ("complex128", "complex128"))
    if hasattr(torch, attr)}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory exists but fails integrity validation
    (truncated blob, checksum mismatch, unreadable manifest/structure)."""


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype, as the manifest records it."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype for {dtype}") from None


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown leaf dtype {name!r}") from None


# ------------------------------------------------------------- the tree
def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, bool, int,
                          float, complex))


def _as_tensor(x: Any) -> torch.Tensor:
    """A leaf as a tensor with ``np.asarray``'s dtype rules (a Python
    float is float64, an int int64); tensors keep their device."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # an ml_dtypes array from the JAX side: its 16-bit words
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _leaf_dtype(x: Any) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return _torch_dtype(np.asarray(x).dtype.name)


def _leaf_shape(x: Any) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) \
        else tuple(np.shape(x))


def flatten_tree(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, structure)`` of a tree, leaves in ``jax.tree_util``'s
    order (dict keys sorted; a namedtuple flattens as a tuple; ``None``
    holds no leaf).  ``structure`` is plain JSON."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {"dict": [[k, walk(node[k])] for k in sorted(node)]}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {kind: [walk(v) for v in node]}
        if not _is_leaf(node):
            raise TypeError(f"cannot checkpoint a leaf of type "
                            f"{type(node).__name__}")
        leaves.append(node)
        return "*"

    return leaves, walk(tree)


def unflatten_tree(structure: Any, leaves: List[Any]) -> Any:
    """The inverse of :func:`flatten_tree` (lists and tuples as such)."""
    it = iter(leaves)
    n = [0]

    def build(node):
        if node is None:
            return None
        if node == "*":
            n[0] += 1
            return next(it)
        if not isinstance(node, dict) or len(node) != 1:
            raise ValueError(f"malformed structure node {node!r}")
        (kind, body), = node.items()
        if kind == "dict":
            return {k: build(v) for k, v in body}
        if kind == "list":
            return [build(v) for v in body]
        if kind == "tuple":
            return tuple(build(v) for v in body)
        raise ValueError(f"malformed structure node kind {kind!r}")

    out = build(structure)
    if n[0] != len(leaves):
        raise ValueError(f"structure holds {n[0]} leaves, got {len(leaves)}")
    return out


def _structure_repr(node: Any) -> str:
    if node is None:
        return "None"
    if node == "*":
        return "*"
    (kind, body), = node.items()
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_structure_repr(v)}"
                               for k, v in body) + "}"
    inner = ", ".join(_structure_repr(v) for v in body)
    return f"[{inner}]" if kind == "list" else f"({inner}{',' * (len(body) == 1)})"


# ------------------------------------------------------------ integrity
def _chunk_bytes() -> int:
    return max(1, int(os.environ.get(_ENV_CHUNK, str(_DEFAULT_CHUNK))))


def _crc_chunks(data, chunk: int) -> List[int]:
    """Chunked CRC32 of a bytes-like (memoryview-able) buffer."""
    view = memoryview(data)
    return [
        zlib.crc32(view[off: off + chunk]) & 0xFFFFFFFF
        for off in range(0, len(view), chunk)
    ] or [0]


def _integrity_record(files: Dict[str, Any], chunk: int) -> dict:
    return {
        "algo": "crc32",
        "chunk_bytes": chunk,
        "files": {
            name: {
                "nbytes": len(memoryview(data)),
                "chunks": _crc_chunks(data, chunk),
            }
            for name, data in files.items()
        },
    }


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=_torch_dtype(name)).element_size()


def _manifest_leaf_nbytes(manifest: dict) -> int:
    """Blob size implied by the manifest's leaf shapes/dtypes."""
    total = 0
    for leaf in manifest["leaves"]:
        n = 1
        for d in leaf["shape"]:
            n *= int(d)
        total += n * _itemsize(leaf["dtype"])
    return total


def _structure_file(files) -> str:
    """The structure file a checkpoint's integrity record (or directory)
    vouches for: the port's, else the JAX package's pickle."""
    if _STRUCTURE in files or _TREEDEF not in files:
        return _STRUCTURE
    return _TREEDEF


# ------------------------------------------------------------------ save
def _snapshot(leaves: List[torch.Tensor]) -> torch.Tensor:
    """``data.bin``'s bytes in host memory: leaves on the card copied
    into their slices of one pinned buffer, one stream synchronisation a
    device; runs of host leaves flattened into theirs by the native
    library."""
    nbytes = [t.numel() * t.element_size() for t in leaves]
    cuda = [t.device for t in leaves if t.is_cuda]
    blob = torch.empty((sum(nbytes),), dtype=torch.uint8,
                       pin_memory=bool(cuda))
    run: List[torch.Tensor] = []
    run_off = off = 0
    for t, nb in zip(leaves, nbytes):
        if t.is_cuda:
            if run:
                csrc.flatten(run, out=blob[run_off:off])
                run = []
            src = t.contiguous().reshape(-1)
            if src.dtype != torch.uint8:
                src = src.view(torch.uint8)
            blob[off:off + nb].copy_(src, non_blocking=True)
        else:
            if not run:
                run_off = off
            run.append(t)
        off += nb
    if run:
        csrc.flatten(run, out=blob[run_off:off])
    for dev in set(cuda):
        torch.cuda.current_stream(dev).synchronize()
    return blob


def _prepare(tree: Any) -> Tuple[List[dict], Any, torch.Tensor]:
    leaves, structure = flatten_tree(tree)
    tensors = [_as_tensor(x) for x in leaves]
    records = [{"shape": list(t.shape), "dtype": _dtype_name(t.dtype)}
               for t in tensors]
    return records, structure, _snapshot(tensors)


def save(path: str, tree: Any) -> None:
    """Persist a tree of tensors (and scalars) to ``path`` (a dir).

    Atomic visibility: everything is written into ``path + ".tmp"`` and
    renamed into place, so a reader can never observe a half-written
    checkpoint.  OVERWRITING an existing path parks the old copy at
    ``path + ".old"`` until the new rename lands (restored if the rename
    fails, so even retry exhaustion cannot lose the previous checkpoint).

    Transient ``OSError``\\ s during the write are retried with bounded
    exponential backoff and jitter (``APEX_TPU_IO_RETRIES`` /
    ``APEX_TPU_IO_BACKOFF_BASE`` / ``APEX_TPU_IO_BACKOFF_MAX``); every
    attempt restarts from a fresh tmp dir."""
    t0 = time.perf_counter()
    records, structure, blob = _prepare(tree)
    _write_snapshot(path, records, structure, blob, t0)


def _write_snapshot(path: str, records: List[dict], structure: Any,
                    blob: torch.Tensor, t0: float) -> None:
    data = blob.numpy()
    structure_bytes = json.dumps(structure).encode()
    manifest = {
        # human-readable only; restore() reads structure.json
        "treedef_repr": _structure_repr(structure),
        "leaves": records,
        "integrity": _integrity_record(
            {_DATA: data, _STRUCTURE: structure_bytes}, _chunk_bytes()),
    }
    retry_io(
        lambda: _write_checkpoint_dir(path, manifest, data,
                                      structure_bytes),
        describe=f"checkpoint save to {path}",
    )
    _events.emit(
        "checkpoint_save", path=path, bytes=int(data.nbytes),
        duration_s=round(time.perf_counter() - t0, 4),
    )


def _write_checkpoint_dir(path: str, manifest: dict, blob: np.ndarray,
                          structure_bytes: bytes) -> None:
    """One write attempt: fresh tmp dir, three files, atomic rename.
    Idempotent, so the retry wrapper can call it repeatedly.

    Overwrite semantics never destroy the previous checkpoint before
    the new one lands: the old dir is parked at ``path + ".old"``,
    restored if the tmp→final rename fails (so retry exhaustion leaves
    the previous checkpoint in place, not a hole), and removed only
    after the new checkpoint is visible."""
    import shutil

    tmp = path.rstrip("/") + ".tmp"
    old = path.rstrip("/") + ".old"
    shutil.rmtree(tmp, ignore_errors=True)  # stale husk from a crash/retry
    os.makedirs(tmp)
    with _open(os.path.join(tmp, _DATA), "wb") as f:
        f.write(memoryview(blob))
    with _open(os.path.join(tmp, _STRUCTURE), "wb") as f:
        f.write(structure_bytes)
    # manifest last: its presence marks the payload files complete
    with _open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if not os.path.isdir(path) and os.path.isdir(old):
        # a previous attempt (or process) parked the old checkpoint and
        # died before restoring it: bring it back rather than delete it
        os.rename(old, path)
    else:
        shutil.rmtree(old, ignore_errors=True)  # stale husk
    moved_aside = False
    # only a directory is a previous checkpoint; a non-dir at `path` is
    # a caller mistake and the rename below fails loudly on it
    if os.path.isdir(path):
        os.rename(path, old)
        moved_aside = True
    try:
        _replace(tmp, path)
    except BaseException:
        if moved_aside:
            try:
                os.rename(old, path)  # put the previous checkpoint back
            except OSError:
                logger.exception(
                    "could not restore previous checkpoint %s after a "
                    "failed rename", path,
                )
        raise
    if moved_aside:
        shutil.rmtree(old, ignore_errors=True)


# ---------------------------------------------------------------- verify
def verify(path: str, *, deep: bool = True,
           raise_transient: bool = False) -> List[str]:
    """Integrity-check a checkpoint directory (the port's or the JAX
    package's); returns the names of the files that fail (empty ==
    valid).

    Checks, in order: the manifest parses; each checksummed file exists
    with the recorded byte length; its chunked CRC32s match (read
    streaming, ``chunk_bytes`` at a time); the integrity record covers
    ``data.bin`` and a structure file (``structure.json``, or a JAX
    checkpoint's ``treedef.pkl``).  Checkpoints without an integrity
    record fall back to structural checks.  A manifest that parses but
    is structurally mangled is reported as a corrupt manifest.

    ``deep=False`` skips the CRC streaming (stat-level checks only).
    ``raise_transient=True`` re-raises ``OSError``\\ s that do NOT mean
    "file is missing", so one storage blip cannot condemn a healthy
    checkpoint.  Each verification emits a ``checkpoint_verify`` event."""
    t0 = time.perf_counter()
    bad = _verify_impl(path, deep=deep, raise_transient=raise_transient)
    _events.emit(
        "checkpoint_verify", path=path, deep=deep, ok=not bad,
        bad_files=list(bad),
        duration_s=round(time.perf_counter() - t0, 4),
    )
    return bad


def _verify_impl(path: str, *, deep: bool,
                 raise_transient: bool) -> List[str]:
    _recover_parked(path)
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    except OSError as e:
        _maybe_reraise_transient(e, raise_transient)
        return [_MANIFEST]
    except ValueError:
        return [_MANIFEST]
    try:
        return _verify_against_manifest(
            path, manifest, deep=deep, raise_transient=raise_transient
        )
    except (KeyError, TypeError, AttributeError, ValueError):
        return [_MANIFEST]  # parseable but structurally corrupt


def _maybe_reraise_transient(e: OSError, raise_transient: bool) -> None:
    if raise_transient and not isinstance(
            e, (FileNotFoundError, NotADirectoryError)):
        raise e


def _recover_parked(path: str) -> None:
    """If ``path`` is absent but an overwrite-mode save crashed between
    parking the previous checkpoint at ``path + ".old"`` and landing
    the new rename, bring the parked copy back."""
    old = path.rstrip("/") + ".old"
    if not os.path.isdir(path) and os.path.isdir(old):
        try:
            os.rename(old, path)
            logger.warning(
                "recovered checkpoint %s from the %s parked by a "
                "crashed overwrite save", path, old,
            )
        except OSError:
            pass  # lost a race with a concurrent writer/reader


def _verify_against_manifest(path: str, manifest: dict, *,
                             deep: bool = True,
                             raise_transient: bool = False) -> List[str]:
    bad: List[str] = []
    integrity = manifest.get("integrity")
    if integrity is None:  # legacy checkpoint: length/existence only
        try:
            actual = os.path.getsize(os.path.join(path, _DATA))
            if actual != _manifest_leaf_nbytes(manifest):
                bad.append(_DATA)
        except OSError as e:
            _maybe_reraise_transient(e, raise_transient)
            bad.append(_DATA)
        present = [n for n in (_STRUCTURE, _TREEDEF)
                   if os.path.isfile(os.path.join(path, n))]
        if not present:
            bad.append(_STRUCTURE)
        return bad

    chunk = int(integrity.get("chunk_bytes", _DEFAULT_CHUNK))
    for name, rec in integrity["files"].items():
        fpath = os.path.join(path, name)
        try:
            if os.path.getsize(fpath) != rec["nbytes"]:
                bad.append(name)
                continue
            if not deep:
                continue
            crcs = []
            with open(fpath, "rb") as f:
                while True:
                    piece = f.read(chunk)
                    if not piece:
                        break
                    crcs.append(zlib.crc32(piece) & 0xFFFFFFFF)
            if (crcs or [0]) != rec["chunks"]:
                bad.append(name)
        except OSError as e:
            _maybe_reraise_transient(e, raise_transient)
            bad.append(name)
    # a corrupted-but-parseable manifest can LOSE an integrity entry;
    # an unchecksummed payload file must read as corrupt, not clean
    for required in (_DATA, _structure_file(integrity["files"])):
        if required not in integrity["files"]:
            bad.append(required)
    # the blob must also agree with the leaves it claims to contain
    if _DATA not in bad:
        expected = _manifest_leaf_nbytes(manifest)
        if integrity["files"][_DATA]["nbytes"] != expected:
            bad.append(_DATA)
    return bad


def _check_integrity_in_memory(manifest: dict, buffers: Dict[str, Any]
                               ) -> List[str]:
    """Replay the manifest's checksums against already-read buffers
    (no second disk pass).  Returns failing file names."""
    integrity = manifest.get("integrity")
    if integrity is None:
        return []  # legacy checkpoint: nothing to replay
    chunk = int(integrity.get("chunk_bytes", _DEFAULT_CHUNK))
    bad = []
    for name, rec in integrity["files"].items():
        data = buffers.get(name)
        if data is None:
            continue
        view = memoryview(data)
        if len(view) != rec["nbytes"] or \
                _crc_chunks(data, chunk) != rec["chunks"]:
            bad.append(name)
    # same coverage rule as verify(): a manifest whose integrity
    # section lost a payload entry cannot vouch for that file
    for name in buffers:
        if name not in integrity["files"]:
            bad.append(name)
    return bad


# --------------------------------------------------------------- restore
def restore(path: str, target: Optional[Any] = None,
            verify_integrity: bool = False) -> Any:
    """Load a tree saved by :func:`save` (or by the JAX package's
    ``checkpoint.save``, with ``target``).  Leaves come back as host
    tensors.  With ``target`` given, the stored structure is validated
    against it and leaves are cast onto the target's dtypes (a Python
    float counts as float64, an int as int64, as ``np.asarray`` has it).

    A JAX-written checkpoint holds its structure only as a pickled
    ``PyTreeDef``, which is never unpickled here: ``target``'s structure
    stands in for it, and without ``target`` such a checkpoint raises
    ``ValueError``.

    The blob's byte length is always validated against the
    manifest-computed size before it is split; ``verify_integrity=True``
    additionally replays the stored checksums against the bytes just
    read (no second disk pass).  Corruption raises
    :class:`CheckpointCorruptError`."""
    t0 = time.perf_counter()
    _recover_parked(path)
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    except ValueError as e:  # truncated / garbled JSON
        raise CheckpointCorruptError(
            f"checkpoint {path}: unreadable manifest: {e}"
        ) from e
    has_own = os.path.isfile(os.path.join(path, _STRUCTURE))
    jax_written = not has_own and os.path.isfile(
        os.path.join(path, _TREEDEF))
    structure_name = _TREEDEF if jax_written else _STRUCTURE
    if jax_written and target is None:
        raise ValueError(
            f"checkpoint {path} was written by the JAX package (its "
            "structure is a pickled PyTreeDef, which is never unpickled "
            "here): restore it with target=")
    with open(os.path.join(path, structure_name), "rb") as f:
        structure_bytes = f.read()
    blob = np.fromfile(os.path.join(path, _DATA), np.uint8)
    try:
        if verify_integrity:
            bad = _check_integrity_in_memory(
                manifest, {_DATA: blob, structure_name: structure_bytes}
            )
            if bad:
                raise CheckpointCorruptError(
                    f"checkpoint {path} failed integrity check: "
                    f"corrupt file(s) {bad}"
                )
        expected = _manifest_leaf_nbytes(manifest)
        shapes = [tuple(int(d) for d in leaf["shape"])
                  for leaf in manifest["leaves"]]
        dtypes = [_torch_dtype(leaf["dtype"]) for leaf in manifest["leaves"]]
    except (KeyError, TypeError, AttributeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path}: structurally corrupt manifest: {e!r}"
        ) from e
    if blob.nbytes != expected:
        raise CheckpointCorruptError(
            f"checkpoint {path}: {_DATA} holds {blob.nbytes} bytes but "
            f"the manifest's leaves describe {expected} — truncated or "
            f"partially written checkpoint"
        )
    if jax_written:
        t_leaves, structure = flatten_tree(target)
        if len(t_leaves) != len(shapes):
            raise ValueError(
                f"checkpoint structure mismatch: saved {len(shapes)} "
                f"leaves, target has {len(t_leaves)}")
    else:
        try:
            structure = json.loads(structure_bytes)
            unflatten_tree(structure, [None] * len(shapes))
        except ValueError as e:
            raise CheckpointCorruptError(
                f"checkpoint {path}: unreadable structure: {e!r}"
            ) from e
    leaves = csrc.unflatten(torch.from_numpy(blob), shapes, dtypes)
    if target is not None:
        t_leaves, t_structure = flatten_tree(target)
        if t_structure != structure:
            raise ValueError(
                f"checkpoint structure mismatch: saved "
                f"{_structure_repr(structure)}, target "
                f"{_structure_repr(t_structure)}"
            )
        for t, r in zip(t_leaves, leaves):
            if _leaf_shape(t) != tuple(r.shape):
                raise ValueError(
                    f"leaf shape mismatch: saved {tuple(r.shape)}, "
                    f"target {_leaf_shape(t)}"
                )
        leaves = [r.to(_leaf_dtype(t)) for t, r in zip(t_leaves, leaves)]
    tree = unflatten_tree(structure, leaves)
    _events.emit(
        "checkpoint_restore", path=path, bytes=int(blob.nbytes),
        verified=verify_integrity,
        duration_s=round(time.perf_counter() - t0, 4),
    )
    return tree


# ------------------------------------------------------------ async save
class _PendingSave:
    """Handle for an in-flight :func:`save_async`; ``result()`` blocks
    until the write lands (re-raising any writer exception)."""

    def __init__(self, thread, box):
        self._thread = thread
        self._box = box

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still in flight")
        if self._box["exc"] is not None:
            raise self._box["exc"]


_pending_saves: list = []


def save_async(path: str, tree: Any) -> _PendingSave:
    """:func:`save` with the checksums and the file writes off the
    training thread.

    The snapshot happens SYNCHRONOUSLY before returning: the card's
    leaves are copied into one pinned host buffer and the stream is
    synchronised once, and host leaves are flattened into it, because
    the port's optimizers update parameters and state in place and the
    next step must not race the copy.  The CRCs and the file writes then
    run in a daemon thread (both release the GIL), under the same retry
    policy as the sync path.

    Returns a handle; call ``result()`` before depending on the files,
    or :func:`wait_pending_saves` to drain everything.  Concurrent saves
    to the SAME path are the caller's race to avoid (step-numbered dirs
    via :func:`save_step` never collide)."""
    t0 = time.perf_counter()
    # the snapshot travels in a clearable cell: the writer drops it in
    # `finally`, so neither a kept (failed) handle nor an exception
    # traceback can pin a checkpoint-sized host buffer in memory
    payload = [_prepare(tree)]
    box = {"exc": None}

    def writer():
        try:
            _write_snapshot(path, *payload[0], t0)
        except BaseException as e:  # surfaced via result()
            e.__traceback__ = None  # frames reference the snapshot
            box["exc"] = e
        finally:
            payload.clear()

    t = threading.Thread(target=writer, daemon=True,
                         name=f"ckpt-save:{os.path.basename(path)}")
    t.start()
    handle = _PendingSave(t, box)
    _pending_saves.append(handle)
    if len(_pending_saves) > 64:
        # prune cleanly-finished handles only: a completed-with-error
        # handle must survive so wait_pending_saves still reports it
        _pending_saves[:] = [
            h for h in _pending_saves
            if not h.done() or h._box["exc"] is not None
        ]
    return handle


def wait_pending_saves(timeout: Optional[float] = None) -> None:
    """Block until every :func:`save_async` issued so far has landed
    (call before process exit / after the last step).

    Joins ALL handles before raising — a failed early save must not
    leave later in-flight writers to be killed mid-file by process
    exit — then raises the first failure (others noted in its message).
    ``timeout`` bounds the WHOLE drain, not each handle.  Handles that
    did not finish within the timeout STAY tracked."""
    deadline = None if timeout is None else time.monotonic() + timeout
    errors = []
    drained = []
    for h in list(_pending_saves):
        left = (None if deadline is None
                else max(0.0, deadline - time.monotonic()))
        try:
            h.result(left)
            drained.append(h)
        except TimeoutError as e:
            errors.append(e)  # still in flight: keep tracking it
        except Exception as e:
            errors.append(e)
            drained.append(h)  # finished (badly): done tracking
    for h in drained:
        _pending_saves.remove(h)
    if errors:
        if len(errors) > 1:
            raise RuntimeError(
                f"{len(errors)} checkpoint saves failed; first: "
                f"{errors[0]!r}; also: "
                + "; ".join(repr(e) for e in errors[1:3])
            ) from errors[0]
        raise errors[0]


# ----------------------------------------------------------------- steps
def save_step(root: str, step: int, tree: Any) -> str:
    """Save under ``root/step_<N>``."""
    path = os.path.join(root, f"step_{step}")
    save(path, tree)
    return path


def _steps_desc(root: str) -> List[int]:
    """All ``step_<N>`` directory numbers under ``root``, newest first
    (``.tmp``/``.old`` husks and foreign names excluded)."""
    if not os.path.isdir(root):
        return []
    return sorted(
        (
            int(m.group(1))
            for d in os.listdir(root)
            if (m := re.fullmatch(r"step_(\d+)", d))
        ),
        reverse=True,
    )


def latest_step(root: str) -> Optional[int]:
    steps = _steps_desc(root)
    return steps[0] if steps else None


def latest_valid_step(root: str) -> Optional[int]:
    """Newest step directory that passes :func:`verify` (None if no
    step verifies).  Corrupt newer steps are logged and skipped."""
    for step in _steps_desc(root):
        path = os.path.join(root, f"step_{step}")
        bad = verify(path)
        if not bad:
            return step
        logger.warning(
            "skipping corrupt checkpoint %s (failed files: %s)", path, bad
        )
    return None


def restore_latest_valid(root: str, target: Optional[Any] = None
                         ) -> Tuple[Optional[Any], Optional[int]]:
    """Restore the newest checkpoint under ``root`` that loads with its
    checksums intact, walking backwards past corrupt / truncated /
    incomplete directories.  Returns ``(tree, step)``, or
    ``(None, None)`` when no checkpoint survives.

    Each candidate is loaded with ``verify_integrity=True``, so a healthy
    resume reads every file exactly once.  A structure/shape mismatch
    against ``target`` still raises: that is a caller bug, not storage
    corruption."""
    for step in _steps_desc(root):
        path = os.path.join(root, f"step_{step}")
        try:
            return restore(path, target=target, verify_integrity=True), \
                step
        except (CheckpointCorruptError, OSError) as e:
            logger.warning(
                "skipping corrupt checkpoint %s (%s); "
                "falling back to an older step", path, e,
            )
            _events.emit(
                "checkpoint_corrupt_fallback", path=path, step=step,
                error=str(e)[:300],
            )
    return None, None


def restore_step(root: str, target: Optional[Any] = None,
                 step: Optional[int] = None) -> Any:
    """Resume from the given (or latest) step directory."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    return restore(os.path.join(root, f"step_{step}"), target)
