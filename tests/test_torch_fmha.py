"""The port's ``contrib.fmha`` (packed varlen attention) against the JAX
package's.

The same numpy ``qkv (total, 3, heads, d)``, ``cu_seqlens`` and output
cotangent go through ``apex_tpu.contrib.fmha.fmha`` with ``jax.vjp`` and
through ``apex_tpu_torch.contrib.fmha.fmha`` on CPU tensors with
``torch.autograd``: the same scatter into a ``(b, max_s)`` batch with
query padding -1 and key padding -2, one attention, the same gather.
With ``implementation`` a rung, the JAX side runs that rung's Pallas
bodies in interpret mode and the port its kernels' plain versions; with
None, JAX takes its CPU default (the XLA reference) and the port its
ladder.  Tolerances: fp32 on both sides, 1e-5 for the output and 5e-5
for the gradient (sums of up to max_s products in another order),
relative and absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.fmha import fmha as jax_fmha
from apex_tpu_torch.contrib.fmha import FMHA, fmha
from apex_tpu_torch.ops.common import launch_counts, reset_launch_counts

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def packed(lengths, heads, d, seed):
    rng = np.random.RandomState(seed)
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    qkv = rng.randn(cu[-1], 3, heads, d).astype(np.float32)
    dout = rng.randn(cu[-1], heads, d).astype(np.float32)
    return qkv, cu, dout


def jax_run(qkv, cu, dout, max_s, causal, impl):
    f = lambda x: jax_fmha(x, jnp.asarray(cu), max_s, causal=causal,
                           implementation=impl)
    out, vjp = jax.vjp(f, jnp.asarray(qkv))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(dout))[0])


def port_run(qkv, cu, dout, max_s, causal, impl):
    x = torch.from_numpy(qkv).requires_grad_()
    out = fmha(x, torch.from_numpy(cu), max_s, causal=causal,
               implementation=impl)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("lengths, max_s, causal, impl", [
    ([5, 17, 9, 1], 24, False, "short"),
    ([5, 17, 9, 1], 24, True, "short"),
    ([30, 64, 2], 64, False, "mid"),
    ([30, 64, 2], 80, True, "mid"),
    ([40, 7, 96], 96, False, "pallas"),
    ([40, 7, 96], 128, True, "pallas"),
    ([12, 33, 20, 8], 40, False, None),
    ([12, 33, 20, 8], 40, True, None),
])
def test_fmha_matches_jax(lengths, max_s, causal, impl):
    qkv, cu, dout = packed(lengths, 2, 64, seed=sum(lengths) + causal)
    want_out, want_g = jax_run(qkv, cu, dout, max_s, causal, impl)
    got_out, got_g = port_run(qkv, cu, dout, max_s, causal, impl)
    assert got_out.shape == (cu[-1], 2, 64)
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL)
    np.testing.assert_allclose(got_g, want_g, **GRAD_TOL)


def test_module_wrapper_and_rungs_agree():
    """``FMHA(causal, implementation)(qkv, cu_seqlens, max_s)`` is
    ``fmha``; the three rungs give one function; only the segment
    instances' counters see the launches a rung's kernels would make
    (none on the CPU: the plain versions run)."""
    qkv, cu, _ = packed([9, 30, 21], 2, 128, seed=3)
    x = torch.from_numpy(qkv)
    reset_launch_counts()
    outs = [FMHA(causal=True, implementation=impl)(x, torch.from_numpy(cu),
                                                    48)
            for impl in ("short", "mid", "pallas")]
    for out in outs[1:]:
        np.testing.assert_allclose(out.numpy(), outs[0].numpy(), **FWD_TOL)
    torch.testing.assert_close(
        outs[0], fmha(x, cu, 48, causal=True, implementation="short"),
        rtol=0, atol=0)
    assert not any(launch_counts().values())


def test_each_token_sees_only_its_sequence():
    """A token's output is attention over its own sequence alone: the
    same as running that sequence unpacked."""
    from apex_tpu_torch.ops.attention import mha_reference

    qkv, cu, _ = packed([6, 11, 3], 2, 64, seed=8)
    out = fmha(torch.from_numpy(qkv), torch.from_numpy(cu), 16)
    for i in range(3):
        seq = torch.from_numpy(qkv[cu[i]:cu[i + 1]])
        q, k, v = (seq[:, j].transpose(0, 1)[None] for j in range(3))
        want = mha_reference(q, k, v)[0].transpose(0, 1)
        np.testing.assert_allclose(out[cu[i]:cu[i + 1]].numpy(),
                                   want.numpy(), **FWD_TOL)


def test_fmha_checks_its_arguments():
    qkv, cu, _ = packed([5, 9], 2, 64, seed=1)
    x = torch.from_numpy(qkv)
    with pytest.raises(ValueError, match="max_seq_len"):
        fmha(x, cu, 8)
    with pytest.raises(ValueError, match="cu_seqlens"):
        fmha(x, np.array([0, 5, 13], np.int32), 16)
    with pytest.raises(ValueError, match="total_tokens, 3"):
        fmha(x[:, :2], cu, 16)
