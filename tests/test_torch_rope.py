"""The port's rotary embeddings against ``apex_tpu/ops/rope.py``.

The same numpy positions and activations go through both modules.
Tolerances: the tables agree to 1e-5 absolute at positions up to 5000
(both compute fp32 trig of fp32 angles; the two frameworks' ``pow``,
``cos`` and ``sin`` differ by a few ulps, and at angle 5000 an ulp of the
angle is 5e-4 of a radian, so the values are compared at positions where
both agree to 1e-5), the rotations to 1e-5 relative and absolute.  Within
the port, cached table rows are bit-identical to direct computation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import rope as jax_rope
from apex_tpu_torch.ops import rope as port_rope

torch.set_num_threads(1)  # the suite's parallel workers share the cores

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head_dim", [8, 64, 128])
def test_cos_sin_match_jax(head_dim):
    pos = np.arange(0, 5000, 7, dtype=np.int32)
    want = jax_rope.rope_cos_sin(jnp.asarray(pos), head_dim)
    got = port_rope.rope_cos_sin(torch.from_numpy(pos), head_dim)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (len(pos), head_dim // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 40, 16).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    want = jax_rope.apply_rope(jx, position_offset=5, base=500.0)
    got = port_rope.apply_rope(tx, position_offset=5, base=500.0)
    assert got.dtype == tx.dtype
    tol = TOL if dtype == np.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_table_rows_are_bit_identical_to_direct_computation():
    port_rope._TABLE_CACHE.clear()
    cos_t, sin_t = port_rope.rope_table(4096, 128)
    pos = torch.tensor([0, 1, 17, 2048, 3000, 4095])
    cos, sin = port_rope.rope_cos_sin(pos, 128)
    assert torch.equal(cos_t[pos], cos) and torch.equal(sin_t[pos], sin)
    # the cache hands back the same tables
    again = port_rope.rope_table(4096, 128)
    assert again[0] is cos_t and again[1] is sin_t


def test_table_matches_jax_table():
    want = jax_rope.rope_table(256, 32, base=10000.0)
    got = port_rope.rope_table(256, 32, base=10000.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_apply_rope_at_per_sequence_positions():
    """Each slot at its own position: tables, the cache and direct trig
    give the same bits, and agree with JAX."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 2, 1, 32).astype(np.float32)
    pos = np.array([[4], [900], [63]], np.int32)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    direct = port_rope.apply_rope_at(tx, tpos)
    cached = port_rope.apply_rope_at(tx, tpos, max_len=1024)
    tables = port_rope.apply_rope_at(
        tx, tpos, tables=port_rope.rope_table(1024, 32))
    assert torch.equal(direct, cached) and torch.equal(direct, tables)
    want = jax_rope.apply_rope_at(jnp.asarray(x), jnp.asarray(pos),
                                  max_len=1024)
    np.testing.assert_allclose(direct.numpy(), np.asarray(want), **TOL)


def test_full_sequence_equals_incremental():
    """Rotating a whole sequence equals rotating each position on its own
    through the cached table: what prefill and decode each do."""
    x = torch.randn(1, 2, 12, 16, generator=torch.Generator().manual_seed(2))
    full = port_rope.apply_rope(x)
    steps = torch.cat([port_rope.apply_rope_at(x[:, :, i:i + 1],
                                               torch.tensor([i]), max_len=64)
                       for i in range(12)], dim=2)
    assert torch.equal(full, steps)


def test_odd_head_dim_and_bad_positions_raise():
    with pytest.raises(ValueError, match="even head_dim"):
        port_rope.rope_cos_sin(torch.arange(4), 7)
    with pytest.raises(ValueError, match="per-sequence"):
        port_rope.apply_rope_at(torch.zeros(2, 3, 8),
                                torch.zeros(2, 3, dtype=torch.int64))
