"""The port's threefry2x32 PRNG (``apex_tpu_torch.random``) against
``jax.random``, bit for bit.

JAX runs here with its defaults (``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True``, 64-bit types off), which the first
test pins, since every other one depends on them.  Keys cross as their
two uint32 words; every comparison is exact.  The per-rank key helpers
of ``transformer.tensor_parallel.random`` are checked against the JAX
ones inside a one-device ``shard_map``, where each folds in rank 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.tensor_parallel import random as jax_tp_random
from apex_tpu_torch import random as R
from apex_tpu_torch.transformer.tensor_parallel import random as tp_random

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, -1, -5, -(2 ** 31),
         2 ** 32 + 7, 2 ** 40 + 3, 2 ** 63 - 1]


def jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed))


def test_jax_defaults_are_the_ones_ported():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    got = R.PRNGKey(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, jkey(seed))


def test_prng_key_rejects_what_int64_cannot_hold():
    with pytest.raises(OverflowError):
        R.PRNGKey(2 ** 63)


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31, 2 ** 32 - 1, 123456789])
@pytest.mark.parametrize("seed", [0, 3, 2 ** 32 - 1])
def test_fold_in_matches_jax(seed, data):
    np.testing.assert_array_equal(
        R.fold_in(R.PRNGKey(seed), data),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


def test_fold_in_rejects_data_outside_uint32():
    for data in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            R.fold_in(R.PRNGKey(0), data)


@pytest.mark.parametrize("num", [1, 2, 5, 12, 100])
def test_split_matches_jax(num):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    got = R.split(np.asarray(key), num)
    assert got.shape == (num, 2) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 11), (1000,)])
def test_bits_uniform_and_bernoulli_match_jax(shape):
    key = jax.random.PRNGKey(2024)
    k = np.asarray(key)
    want_bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(R.bits(k, shape), want_bits)
    np.testing.assert_array_equal(R.uniform(k, shape),
                                  np.asarray(jax.random.uniform(key, shape)))
    np.testing.assert_array_equal(
        R.bernoulli(k, 0.9, shape),
        np.asarray(jax.random.bernoulli(key, 0.9, shape)))
    # the tensor draws are the same numbers, in plain PyTorch
    np.testing.assert_array_equal(
        R.bits_tensor(k, shape, "cpu").numpy().astype(np.uint32), want_bits)
    np.testing.assert_array_equal(
        R.uniform_tensor(k, shape, "cpu").numpy(),
        np.asarray(jax.random.uniform(key, shape)))


def test_seed_of_is_a_scalar_draw():
    key = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    assert R.seed_of(np.asarray(key)) == int(
        jax.random.bits(key, dtype=jnp.uint32))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=-(2 ** 63), max_value=2 ** 63 - 1),
       data=st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_bernoulli_at_p_09_matches_jax_for_any_seed(seed, data):
    """The hidden-dropout draw: ``bernoulli(fold_in(PRNGKey(seed), d),
    0.9)`` over a ragged shape, for any int64 seed and uint32 data."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    got = R.bernoulli(R.fold_in(R.PRNGKey(seed), data), 0.9, (3, 37))
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.bernoulli(key, 0.9, (3, 37))))


def test_key_from_jax_takes_raw_and_typed_keys():
    key = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    np.testing.assert_array_equal(R.key_from_jax(np.asarray(key)),
                                  np.asarray(key))
    typed = jax.random.key(7)
    np.testing.assert_array_equal(
        R.key_from_jax(np.asarray(jax.random.key_data(typed))), jkey(7))
    with pytest.raises(ValueError):
        R.key_from_jax(np.zeros(3, np.uint32))
    with pytest.raises(TypeError):
        R.fold_in(np.zeros(2, np.int64), 0)


def test_draws_leave_torch_generator_alone():
    before = torch.random.get_rng_state()
    R.uniform_tensor(R.PRNGKey(3), (64,), "cpu")
    R.split(R.PRNGKey(3), 4)
    assert torch.equal(torch.random.get_rng_state(), before)


def test_rank_keys_match_jax_at_world_size_1():
    """``model_parallel_key``/``data_parallel_key`` fold in the rank even
    at world size 1, as the JAX helpers do inside ``shard_map``."""
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(devices=jax.devices()[:1])
    try:
        def both(key):
            return (jax_tp_random.model_parallel_key(key),
                    jax_tp_random.data_parallel_key(key),
                    jax_tp_random.model_parallel_key(
                        jax_tp_random.data_parallel_key(
                            jax.random.fold_in(key, 0))))

        key = jax.random.PRNGKey(77)
        f = jax.jit(jax.shard_map(both, mesh=mesh, in_specs=P(),
                                  out_specs=(P(), P(), P()),
                                  check_vma=False))
        want = [np.asarray(x) for x in f(key)]
    finally:
        parallel_state.destroy_model_parallel()
    k = np.asarray(key)
    np.testing.assert_array_equal(tp_random.model_parallel_key(k), want[0])
    np.testing.assert_array_equal(tp_random.data_parallel_key(k), want[1])
    np.testing.assert_array_equal(
        tp_random.model_parallel_key(tp_random.data_parallel_key(
            R.fold_in(k, 0))), want[2])
    np.testing.assert_array_equal(tp_random.data_parallel_key(k),
                                  R.fold_in(k, 0))
    assert not np.array_equal(tp_random.data_parallel_key(k), k)
