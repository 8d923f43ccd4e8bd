"""The port's sampler against the JAX package's, on the CPU.

Logits, keys and drafts are drawn with numpy and fed to both packages.

- ``sample`` at every temperature x top-k x top-p of the grid gives JAX's
  tokens, and the two floors give JAX's masks.
- The plain Gumbel noise (``ops/sampling.py``) is JAX's
  ``jax.random.gumbel``: the uniform bit for bit, ``-log(u)`` within two
  fp32 ulps, and the noise within two ulps at the scale ``max(|g|, 1)``
  (``g = -log(w)`` with ``w`` near 1 amplifies the last bit of ``w`` in
  ulps of ``g``: an absolute error is what moves an argmax over logits).
- ``fold_in_tensor`` is ``jax.random.fold_in`` bit for bit.
- ``spec_accept`` and ``spec_accept_tree`` at temperature > 0 give JAX's
  targets, accepted lengths and paths over ``chain_tree(4)`` and
  ``offramp_tree(4)``.
- The validation errors are JAX's.
- ``gumbel_argmax`` folds ``ctx`` as ``fold_in_tensor`` does, numbers a
  batch under one key as one ``(R, V)`` draw, and its plan is a function
  of shapes alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serving import sampling as jsampling
from apex_tpu.serving import speculate as jspec
from apex_tpu_torch.ops import sampling as ops_sampling
from apex_tpu_torch.random import fold_in_tensor, keys_tensor
from apex_tpu_torch.serving import sampling as tsampling

torch.set_num_threads(1)  # the suite's parallel workers share the cores

V = 96
TEMPERATURES = (0.5, 1.0, 1.7)
TOP_KS = (None, 1, 5, V)
TOP_PS = (None, 0.3, 0.9, 1.0)


def _logits(seed, shape, scale=2.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


@pytest.mark.parametrize("top_p", TOP_PS, ids=str)
@pytest.mark.parametrize("top_k", TOP_KS, ids=str)
@pytest.mark.parametrize("temperature", TEMPERATURES, ids=str)
def test_sample_matches_jax(temperature, top_k, top_p):
    """Tokens identical for several keys and a (3, V) block; the floors'
    masks identical on the scaled logits wherever ``sample`` applies them
    (``top_k < V``, ``top_p < 1``, as in JAX)."""
    logits = _logits(int(10 * temperature) + (top_k or 0), (3, V))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jsampling.sample(jnp.asarray(logits), key, temperature,
                                top_k, top_p)
        got = tsampling.sample(torch.from_numpy(logits), np.asarray(key),
                               temperature, top_k, top_p)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = logits / np.float32(temperature)
    if top_k is not None and top_k < V:
        want = np.asarray(jsampling._top_k_floor(jnp.asarray(x), top_k))
        got = tsampling._top_k_floor(torch.tensor(x), top_k).numpy()
        np.testing.assert_array_equal(got == -1e30, want == -1e30)
        x = want
    if top_p is not None and top_p < 1.0:
        want = np.asarray(jsampling._top_p_floor(jnp.asarray(x), top_p))
        got = tsampling._top_p_floor(torch.tensor(x), top_p).numpy()
        np.testing.assert_array_equal(got == -1e30, want == -1e30)


@pytest.mark.parametrize("shape", [(1, 32768), (4, 1000), (3, 7)],
                         ids=str)
def test_gumbel_noise_matches_jax(shape):
    R, n = shape
    tiny = np.finfo(np.float32).tiny
    for seed in (0, 5, 123):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
        keys = keys_tensor(np.asarray(key), "cpu").expand(R, 2)
        got = ops_sampling.gumbel_noise(keys, None, n, row_stride=n).numpy()
        u = np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                          minval=tiny, maxval=1.0))
        u_got = ops_sampling.gumbel_uniform(keys, None, n, n)
        np.testing.assert_array_equal(u_got.numpy(), u)
        w_want = np.asarray(-jnp.log(jnp.asarray(u)))
        w_got = (-torch.log(u_got)).numpy()
        assert np.abs(w_got.view(np.int32).astype(np.int64)
                      - w_want.view(np.int32).astype(np.int64)).max() <= 2
        scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert (np.abs(got.astype(np.float64) - want) <= 2 * scale).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fold_in_tensor_matches_jax(seed):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 2 ** 32, (64, 2), dtype=np.uint64).astype(
        np.uint32)
    data = rng.randint(0, 2 ** 32, (64,), dtype=np.uint64).astype(np.uint32)
    data[:4] = (0, 1, 2 ** 31, 2 ** 32 - 1)
    got = fold_in_tensor(keys_tensor(keys, "cpu"),
                         torch.from_numpy(data.astype(np.int64))).numpy()
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), int(d)))
                     for k, d in zip(keys, data)])
    np.testing.assert_array_equal(got, want)


def _spec_inputs(seed, rows, slots=6):
    logits = _logits(seed, (slots, rows, V), scale=1.0)
    rng = np.random.RandomState(seed + 100)
    drafts = rng.randint(0, V, (slots, rows - 1)).astype(np.int32)
    keys = np.stack([[np.asarray(jax.random.fold_in(
        jax.random.PRNGKey(50 + s), 30 + j)) for j in range(rows)]
        for s in range(slots)])
    return logits, drafts, keys


@pytest.mark.parametrize("top_k, top_p", [(None, None), (10, 0.9)],
                         ids=["plain", "floored"])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
@pytest.mark.parametrize("tree", [jspec.chain_tree(4), jspec.offramp_tree(4)],
                         ids=["chain4", "offramp4"])
def test_spec_accept_sampled_matches_jax(tree, temperature, top_k, top_p):
    """Drafts follow JAX's own draws on some slots, so accepted prefixes
    and off-ramp paths occur; targets, n_accept and path equal JAX's."""
    R = len(tree)
    logits, drafts, keys = _spec_inputs(R + int(10 * temperature), R)
    draws = np.stack([np.asarray(jax.vmap(
        lambda l, kk: jsampling.sample(l[None], kk, temperature, top_k,
                                       top_p)[0])(
        jnp.asarray(logits[s]), jnp.asarray(keys[s]))) for s in range(6)])
    rng = np.random.RandomState(R)
    for s in range(6):
        for r in range(1, R):
            if rng.rand() < 0.6:
                drafts[s, r - 1] = draws[s, tree[r]]
    tkeys = torch.from_numpy(keys.astype(np.int64))
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    depths = jspec.tree_depths(tree)
    valid = np.array([[depths[r] <= rng.randint(1, 5) for r in range(1, R)]
                      for _ in range(6)])
    out, n, path = tsampling.spec_accept_tree(
        torch.from_numpy(logits), torch.from_numpy(drafts), tree,
        torch.from_numpy(valid), tkeys, **kw)
    for s in range(6):
        jo, jn, jp = jsampling.spec_accept_tree(
            jnp.asarray(logits[s]), jnp.asarray(drafts[s]), tree,
            jnp.asarray(valid[s]), jnp.asarray(keys[s]), **kw)
        np.testing.assert_array_equal(out[s].numpy(), np.asarray(jo))
        assert int(n[s]) == int(jn)
        np.testing.assert_array_equal(path[s].numpy(), np.asarray(jp))
    assert int(n.max()) >= 1
    if tree == jspec.chain_tree(4):
        dlen = valid.sum(1).astype(np.int32)
        t, na = tsampling.spec_accept(
            torch.from_numpy(logits), torch.from_numpy(drafts),
            torch.from_numpy(dlen), tkeys, **kw)
        for s in range(6):
            jt, jn = jsampling.spec_accept(
                jnp.asarray(logits[s]), jnp.asarray(drafts[s]),
                jnp.int32(dlen[s]), jnp.asarray(keys[s]), **kw)
            np.testing.assert_array_equal(t[s].numpy(), np.asarray(jt))
            assert int(na[s]) == int(jn)


_BAD = [
    ("no key", dict(temperature=0.5), "PRNG key"),
    ("negative temperature", dict(temperature=-1.0, key=True), "temperature"),
    ("top_k 0", dict(temperature=0.5, top_k=0, key=True), "top_k"),
    ("top_p 0", dict(temperature=0.5, top_p=0.0, key=True), "top_p"),
    ("top_p above 1", dict(temperature=0.5, top_p=1.5, key=True), "top_p"),
    ("top_k 0 greedy", dict(temperature=0.0, top_k=0), "top_k"),
]


@pytest.mark.parametrize("kw, match", [(b[1], b[2]) for b in _BAD],
                         ids=[b[0] for b in _BAD])
def test_validation_errors_match_jax(kw, match):
    kw = dict(kw)
    logits = _logits(0, (2, V))
    use_key = kw.pop("key", False)
    jkey = jax.random.PRNGKey(0) if use_key else None
    tkey = np.asarray(jkey) if use_key else None
    with pytest.raises(ValueError, match=match):
        jsampling.sample(jnp.asarray(logits), jkey, **kw)
    with pytest.raises(ValueError, match=match):
        tsampling.sample(torch.from_numpy(logits), tkey, **kw)


@pytest.mark.parametrize("rows", [1, 4, 20])
def test_gumbel_argmax_folds_and_numbers_like_jax(rows):
    """The kernel's fold of ``ctx`` is ``fold_in_tensor`` and gives JAX's
    draw under ``fold_in(key, ctx)``; a floor keeps the draw at or above
    it."""
    x = torch.from_numpy(_logits(rows, (rows, V)))
    rng = np.random.RandomState(rows)
    keys = keys_tensor(rng.randint(0, 2 ** 32, (rows, 2), dtype=np.uint64)
                       .astype(np.uint32), "cpu")
    ctx = torch.from_numpy(rng.randint(0, 5000, rows).astype(np.int32))
    got = ops_sampling.gumbel_argmax(x, keys, ctx, 0.8)
    want = ops_sampling.gumbel_argmax(x, fold_in_tensor(keys, ctx), None, 0.8)
    assert torch.equal(got, want)
    for r in range(rows):
        jk = jax.random.fold_in(jnp.asarray(keys[r].numpy().astype(
            np.uint32)), int(ctx[r]))
        assert int(got[r]) == int(jsampling.sample(
            jnp.asarray(x[r].numpy())[None], jk, 0.8)[0])
    floor = torch.from_numpy(np.sort(x.numpy() / np.float32(0.8), 1)
                             [:, -3].copy())
    picked = ops_sampling.gumbel_argmax(x, keys, ctx, 0.8, floor)
    assert ((x / 0.8)[torch.arange(rows), picked.long()] >= floor).all()


def test_sample_plan_depends_on_shapes_alone():
    for rows, vocab in ((4, 32768), (20, 32768), (1, 50), (512, 32768)):
        plan = ops_sampling.sample_plan(rows, vocab)
        assert plan.split & (plan.split - 1) == 0
        assert plan.chunk % ops_sampling.BLOCK == 0
        assert plan.split * plan.chunk >= vocab
        assert (plan.split - 1) * plan.chunk < vocab
        assert rows * plan.split <= max(ops_sampling.TARGET_PROGRAMS, rows)
    assert ops_sampling.sample_plan(4, 32768) == (32, 1024)
    assert ops_sampling.sample_plan(20, 32768) == (8, 4096)
