"""Pretraining data source: memory-mapped token files.

The port's own copy of ``apex_tpu/data/__init__.py`` (numpy only), the
source half of the pretraining input pipeline whose samplers are
:mod:`apex_tpu_torch.transformer.data`; the files are the JAX package's:

- the on-disk format is one flat little-endian token array plus a tiny
  JSON sidecar (dtype, token count) — ``np.memmap`` gives zero-copy
  reads straight from the page cache;
- samples are fixed-length ``seq_len + 1`` windows (input = [:-1],
  target = [1:], the GPT next-token convention), strided by ``seq_len``
  so every token trains exactly once per epoch;
- ``pretraining_batches`` composes a dataset with either Megatron
  sampler into (tokens, targets) numpy pairs, which a trainer copies to
  the card (each data-parallel rank constructs its sampler with its own
  ``data_parallel_rank``).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Tuple

import numpy as np

__all__ = [
    "write_token_file",
    "IndexedTokenDataset",
    "pretraining_batches",
]

_SIDECAR = ".meta.json"


def write_token_file(path: str, tokens, dtype="uint16") -> str:
    """Write a flat token array + sidecar; returns ``path``.

    ``dtype`` uint16 fits vocabs < 65536 (GPT-2's 50k needs uint32 —
    validated against the data's max token).
    """
    arr = np.asarray(tokens)
    dtype = np.dtype(dtype)  # accepts "uint16" and np.uint16 alike
    if arr.size and not np.issubdtype(arr.dtype, np.integer):
        # astype() would silently TRUNCATE in-range floats (3.7 → 3);
        # token ids arriving as floats are a pipeline bug, not data
        raise ValueError(
            f"token ids must be an integer dtype, got {arr.dtype} "
            "(cast explicitly if the values are known-exact)"
        )
    info = np.iinfo(dtype)
    if arr.size and (arr.min() < info.min or arr.max() > info.max):
        raise ValueError(
            f"token ids [{arr.min()}, {arr.max()}] do not fit {dtype}"
        )
    arr.astype(dtype).tofile(path)
    with open(path + _SIDECAR, "w") as f:
        json.dump({"dtype": dtype.name, "n_tokens": int(arr.size),
                   "max_token": int(arr.max()) if arr.size else -1}, f)
    return path


class IndexedTokenDataset:
    """Fixed-window LM samples over a memory-mapped token file."""

    def __init__(self, path: str, seq_len: int):
        with open(path + _SIDECAR) as f:
            meta = json.load(f)
        self._path = path
        self._meta = meta
        self.seq_len = int(seq_len)
        self.tokens = np.memmap(
            path, dtype=meta["dtype"], mode="r", shape=(meta["n_tokens"],)
        )
        # sidecar-recorded vocabulary bound — lets consumers fail fast
        # on a corpus/model vocab mismatch instead of training on
        # clamped/masked garbage embeddings.  For legacy sidecars
        # (written before the field existed) the full-file mmap scan is
        # LAZY: construction stays O(1), the scan runs on first access,
        # and its result is written back so it runs once per corpus,
        # not once per process
        self._max_token = (
            int(meta["max_token"]) if "max_token" in meta else None
        )
        # windows of seq_len+1, strided by seq_len: sample i covers
        # tokens [i*s, i*s + s], so consecutive samples overlap by the
        # one boundary token that becomes both a target and an input
        self.n_samples = max(0, (meta["n_tokens"] - 1) // self.seq_len)
        if self.n_samples == 0:
            raise ValueError(
                f"{path}: {meta['n_tokens']} tokens < one "
                f"seq_len+1={seq_len + 1} window"
            )

    @property
    def max_token(self) -> int:
        if self._max_token is None:
            self._max_token = int(
                self.tokens.max()) if self._meta["n_tokens"] else -1
            meta = dict(self._meta, max_token=self._max_token)
            try:  # upgrade the legacy sidecar — atomically, so a
                # concurrent reader never sees a truncated file and
                # racing writers last-write-win whole documents
                tmp = f"{self._path}{_SIDECAR}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(meta, f)
                os.replace(tmp, self._path + _SIDECAR)
                self._meta = meta
            except OSError:
                pass  # read-only corpus dir: keep the value in-process
        return self._max_token

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < self.n_samples:
            raise IndexError(i)
        start = i * self.seq_len
        # copy: a memmap slice pins the mapping; batches should be
        # plain host arrays by the time they are copied to the card
        return np.asarray(self.tokens[start: start + self.seq_len + 1],
                          dtype=np.int32)


def pretraining_batches(
    dataset: IndexedTokenDataset, sampler
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield this rank's (tokens, targets) micro-batches, each
    (micro_batch, seq_len) int32."""
    for idx_batch in sampler:
        window = np.stack([dataset[i] for i in idx_batch])
        yield window[:, :-1], window[:, 1:]
