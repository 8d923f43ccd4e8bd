"""Per-rank PRNG streams: ``model_parallel_key`` and ``data_parallel_key``.

Counterpart of ``apex_tpu/transformer/tensor_parallel/random.py:37-49``,
where each is ``jax.random.fold_in(key, axis_index(axis))``: a key that
differs across the ranks of one mesh axis, so dropout on sharded
activations differs per shard and on replicated ones agrees.  The fold is
made at every world size, so at world size 1 it is a ``fold_in`` of rank
0, never the identity: the GPT's attention seed is
``bits(model_parallel_key(data_parallel_key(fold_in(layer_key, 0))))``.

Keys are the host-side numpy keys of :mod:`apex_tpu_torch.random`.  The
JAX module's ``checkpoint`` has no counterpart here: the port remats with
``torch.utils.checkpoint``, and since keys are values the recompute draws
the same masks with no RNG state to restore.  The ranks are those of
:mod:`~apex_tpu_torch.transformer.parallel_state` (host ints), so over a
tensor-parallel group the attention-dropout seed differs per rank and a
hidden-dropout key, folded with the data-parallel rank only, agrees
across it, as in JAX.
"""

from __future__ import annotations

from apex_tpu_torch.random import fold_in
from apex_tpu_torch.transformer.parallel_state import (
    get_data_parallel_rank,
    get_tensor_model_parallel_rank,
)

__all__ = ["model_parallel_key", "data_parallel_key"]


def model_parallel_key(key):
    """``fold_in(key, rank)`` with this process's tensor-parallel rank."""
    return fold_in(key, get_tensor_model_parallel_rank())


def data_parallel_key(key):
    """``fold_in(key, rank)`` with this process's data-parallel rank."""
    return fold_in(key, get_data_parallel_rank())
