"""The port's short-sequence attention forward against the JAX package.

The same numpy q/k/v go through ``apex_tpu.ops.attention_short.fmha_short``
with ``implementation="pallas"`` (``_short_fwd_kernel`` in interpret mode
on the CPU) and through ``apex_tpu_torch.ops.attention_short`` on CPU
tensors (the CUDA kernel's plain version).

Tolerance: fp32 inputs, fp32 products on both sides (the JAX kernel's
``hi_precision`` for fp32), so outputs agree to 1e-5 absolute and
relative: the rounding of fp32 sums taken in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention_short import fmha_short as jax_fmha_short
from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops import attention_short as port_short

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("s", [1, 37, 128, 512])
def test_causal_matches_pallas_fp32(s):
    q, k, v = _qkv(1, 2, s, 64, seed=s)
    want = jax_fmha_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, implementation="pallas")
    got = port_short.fmha_short(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_non_causal_with_scale_matches_pallas_fp32():
    q, k, v = _qkv(2, 2, 40, 32, seed=5)
    want = jax_fmha_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, sm_scale=0.3,
                          implementation="pallas")
    got = port_short.fmha_short(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False,
                                sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lse_is_row_logsumexp():
    """``short_fwd`` keeps the row logsumexp (fp32) for the backward."""
    q, k, v = _qkv(1, 2, 37, 64, seed=2)
    _, lse = port_short.short_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(64.0)
    s = np.where(np.tril(np.ones((37, 37), bool)), s, -np.inf)
    m = s.max(-1)
    want = m + np.log(np.exp(s - m[..., None]).sum(-1))
    assert lse.shape == (1, 2, 37) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


def test_ladder_routes_short_and_matches_reference():
    q, k, v = _qkv(1, 2, 64, 32, seed=9)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = port_attention.flash_attention(tq, tk, tv, causal=True)
    want = port_attention.mha_reference(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_ladder_rejects_what_is_not_ported():
    q = torch.zeros((1, 1, 513, 32))
    with pytest.raises(NotImplementedError, match="queue B"):
        port_attention.flash_attention(q, q, q, causal=True)
    q = torch.zeros((1, 1, 8, 32))
    with pytest.raises(NotImplementedError, match="queue B"):
        port_attention.flash_attention(q, q, q, bias=torch.zeros(8, 8))
    with pytest.raises(NotImplementedError, match="queue B"):
        port_attention.flash_attention(q, q, q, dropout_rate=0.1)
