"""The port's vocab-parallel cross entropy against the JAX package at
tensor-parallel world size 1.

The same numpy logits, targets and per-token weights go through
``apex_tpu.transformer.tensor_parallel.cross_entropy`` (inside a
1-device ``shard_map``, where its collectives are identities) and
through ``apex_tpu_torch.transformer.tensor_parallel.cross_entropy``;
the gradient is that of ``sum(weights * loss)``, by ``jax.grad`` and by
``torch.autograd``.

Tolerance: fp32 throughout, per-token losses and gradients to 1e-5
absolute and relative (log-sum-exp over the vocab in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.tensor_parallel import cross_entropy as jax_ce
from apex_tpu_torch.transformer.tensor_parallel import cross_entropy as port_ce

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mesh():
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(
        devices=jax.devices()[:1])
    yield mesh
    parallel_state.destroy_model_parallel()


def _inputs(seed, shape=(3, 7), vocab=96):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(*shape, vocab)).astype(np.float32)
    targets = rng.randint(0, vocab, shape).astype(np.int32)
    weights = rng.rand(*shape).astype(np.float32)
    return logits, targets, weights


def _jax(mesh, fn, args):
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                              check_vma=False))
    return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, args)))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_grad_match_jax(mesh, smoothing):
    logits, targets, weights = _inputs(int(10 * smoothing) + 1)

    def jfn(args):
        lg, tg, wt = args

        def total(lg):
            loss = jax_ce.vocab_parallel_cross_entropy(
                lg, tg, smoothing=smoothing)
            return jnp.sum(loss * wt), loss

        (_, loss), grad = jax.value_and_grad(total, has_aux=True)(lg)
        return loss, grad

    want_loss, want_grad = _jax(mesh, jfn, (logits, targets, weights))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = port_ce.vocab_parallel_cross_entropy(
        tl, torch.from_numpy(targets), smoothing=smoothing)
    (loss * torch.from_numpy(weights)).sum().backward()
    assert loss.dtype == torch.float32 and loss.shape == targets.shape
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), want_grad, **TOL)


def test_lm_head_two_step_matches_jax(mesh):
    rng = np.random.RandomState(4)
    hidden = rng.randn(2, 5, 16).astype(np.float32)
    weight = (0.3 * rng.randn(40, 16)).astype(np.float32)
    targets = rng.randint(0, 40, (2, 5)).astype(np.int32)

    def jfn(args):
        h, w, t = args
        f = lambda h, w: jnp.mean(jax_ce.lm_head_cross_entropy(h, w, t))
        return jax.value_and_grad(f, argnums=(0, 1))(h, w)

    want_loss, (want_dh, want_dw) = _jax(mesh, jfn, (hidden, weight, targets))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (hidden, weight))
    loss = port_ce.lm_head_cross_entropy(th, tw, torch.from_numpy(targets))
    loss.mean().backward()
    np.testing.assert_allclose(loss.mean().item(), want_loss, **TOL)
    np.testing.assert_allclose(th.grad.numpy(), want_dh, **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), want_dw, **TOL)


def test_auto_rule_and_fused_path():
    assert port_ce.FUSED_CE_AUTO_BYTES == jax_ce.FUSED_CE_AUTO_BYTES
    # the flagship step: 8 x 1024 tokens x 32768 vocab x 4 B = 1.07 GB
    assert not port_ce.fused_ce_auto(8 * 1024, 32768)
    assert port_ce.fused_ce_auto(8 * 1024, 32768) == \
        jax_ce.fused_ce_auto(8 * 1024, 32768)
    assert port_ce.fused_ce_auto(64 * 1024, 32768)
    h, w = torch.zeros(2, 4), torch.zeros(8, 4)
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        port_ce.lm_head_cross_entropy(h, w, torch.zeros(2, dtype=torch.long),
                                      fused=True)
