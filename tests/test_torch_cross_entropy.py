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

The fused chunked path (``vocab_parallel_cross_entropy_from_hidden``)
goes through the same comparison for the loss and the gradients of the
hidden states, the weight and the bias, with a few targets outside the
vocab in every case: fp32 to 1e-5 as above; with bf16 hidden states and
weight (the O5 head) the loss to 1e-5 (both sides sum exact bf16
products in fp32) and ``dx``/``dW``, rounded to bf16 once, to one bf16
ulp of their tensor's largest value (2**-7 of it), because the fp32 sums
before that rounding come in another order.
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

torch.set_num_threads(1)  # the suite's parallel workers share the cores

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


def _fused_node(loss):
    """The ``_FusedCE`` node under ``loss``'s reshape, or None."""
    todo = [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None:
            continue
        if type(node).__name__ == "_FusedCEBackward":
            return node
        todo.extend(fn for fn, _ in node.next_functions)
    return None


def test_auto_rule_and_fused_path(mesh):
    assert port_ce.FUSED_CE_AUTO_BYTES == jax_ce.FUSED_CE_AUTO_BYTES
    assert port_ce.FUSED_CE_DEFAULT_CHUNK == jax_ce.FUSED_CE_DEFAULT_CHUNK
    # the flagship step: 8 x 1024 tokens x 32768 vocab x 4 B = 1.07 GB
    assert not port_ce.fused_ce_auto(8 * 1024, 32768)
    assert port_ce.fused_ce_auto(8 * 1024, 32768) == \
        jax_ce.fused_ce_auto(8 * 1024, 32768)
    # 24 x 1024 tokens: 3.2 GB, the fused path
    assert port_ce.fused_ce_auto(24 * 1024, 32768)
    assert port_ce.fused_ce_auto(64 * 1024, 32768)
    # lm_head_cross_entropy(fused=True) is the fused path, as in JAX
    rng = np.random.RandomState(5)
    hidden = rng.randn(2, 5, 16).astype(np.float32)
    weight = (0.3 * rng.randn(64, 16)).astype(np.float32)
    targets = rng.randint(0, 64, (2, 5)).astype(np.int32)

    def jfn(args):
        h, w, t = args
        f = lambda h, w: jnp.mean(jax_ce.lm_head_cross_entropy(
            h, w, t, fused=True, chunk=16))
        return jax.value_and_grad(f, argnums=(0, 1))(h, w)

    want_loss, (want_dh, want_dw) = _jax(mesh, jfn, (hidden, weight, targets))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (hidden, weight))
    loss = port_ce.lm_head_cross_entropy(th, tw, torch.from_numpy(targets),
                                         fused=True, chunk=16)
    assert _fused_node(loss) is not None
    loss.mean().backward()
    np.testing.assert_allclose(loss.mean().item(), want_loss, **TOL)
    np.testing.assert_allclose(th.grad.numpy(), want_dh, **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), want_dw, **TOL)


#: (vocab, chunk, bias, smoothing, dtype): a dividing chunk with and
#: without a bias and smoothing, an auto-shrunk chunk (3126 walks 521),
#: the near-prime fallback (1031 has no divisor in 512..256), bf16
FUSED_CASES = [
    (96, 32, False, 0.0, "float32"),
    (96, 32, True, 0.0, "float32"),
    (96, 32, False, 0.1, "float32"),
    (96, 32, True, 0.1, "float32"),
    (3126, 1024, True, 0.1, "float32"),
    (3126, 1024, False, 0.0, "float32"),
    (1031, 256, True, 0.1, "float32"),
    (96, 32, True, 0.1, "bfloat16"),
    (96, 96, False, 0.0, "bfloat16"),
]


def _bf16_np(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("vocab, chunk, with_bias, smoothing, dtype",
                         FUSED_CASES)
def test_fused_from_hidden_matches_jax(mesh, vocab, chunk, with_bias,
                                       smoothing, dtype):
    rng = np.random.RandomState(vocab + chunk + int(10 * smoothing))
    hidden = rng.randn(3, 6, 16).astype(np.float32)
    weight = (0.3 * rng.randn(vocab, 16)).astype(np.float32)
    bias = (0.5 * rng.randn(vocab)).astype(np.float32) if with_bias \
        else np.zeros(vocab, np.float32)
    targets = rng.randint(0, vocab, (3, 6)).astype(np.int32)
    # targets outside the vocab pick a zero logit
    targets[0, :2] = (-1, vocab + 3)
    weights = rng.rand(3, 6).astype(np.float32)
    bf16 = dtype == "bfloat16"
    if bf16:
        hidden, weight = _bf16_np(hidden), _bf16_np(weight)

    def jfn(args):
        h, w, b, t, g = args
        if bf16:
            h, w = h.astype(jnp.bfloat16), w.astype(jnp.bfloat16)

        def total(h, w, b):
            loss = jax_ce.vocab_parallel_cross_entropy_from_hidden(
                h, w, t, chunk=chunk, bias=b if with_bias else None,
                smoothing=smoothing)
            return jnp.sum(loss * g), loss

        (_, loss), grads = jax.value_and_grad(
            total, argnums=(0, 1, 2), has_aux=True)(h, w, b)
        return loss, jax.tree.map(lambda x: x.astype(jnp.float32), grads)

    want_loss, (want_dh, want_dw, want_db) = _jax(
        mesh, jfn, (hidden, weight, bias, targets, weights))
    tdt = torch.bfloat16 if bf16 else torch.float32
    th = torch.from_numpy(hidden).to(tdt).requires_grad_()
    tw = torch.from_numpy(weight).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    loss = port_ce.vocab_parallel_cross_entropy_from_hidden(
        th, tw, torch.from_numpy(targets), chunk=chunk,
        bias=tb if with_bias else None, smoothing=smoothing)
    (loss * torch.from_numpy(weights)).sum().backward()
    assert loss.dtype == torch.float32 and loss.shape == targets.shape
    assert th.grad.dtype == tw.grad.dtype == tdt
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **TOL)
    if with_bias:
        np.testing.assert_allclose(tb.grad.numpy(), want_db, **TOL)
    else:
        assert tb.grad is None
    for got, want in ((th.grad, want_dh), (tw.grad, want_dw)):
        got = got.float().numpy()
        if bf16:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 ** -7 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, **TOL)


def test_fused_chunking_and_residuals():
    """The chunk shrinks to the largest divisor as JAX's does (BERT's
    30522 walks 5087); the near-prime fallback is the two-step path; the
    forward keeps no logits, only what JAX's residuals hold."""
    for v, c in ((30522, 8192), (3126, 1024), (32000, 8192), (1031, 256),
                 (96, 32)):
        assert port_ce._largest_chunk_divisor(v, c) == \
            jax_ce._largest_chunk_divisor(v, c)
    assert port_ce._largest_chunk_divisor(30522, 8192) == 5087
    n, h, vocab, chunk = 12, 16, 256, 64
    x = torch.randn(n, h, requires_grad=True)
    w = torch.randn(vocab, h, requires_grad=True)
    loss = port_ce.vocab_parallel_cross_entropy_from_hidden(
        x, w, torch.randint(0, vocab, (n,)), chunk=chunk)
    saved = _fused_node(loss).saved_tensors
    shapes = sorted(tuple(t.shape) for t in saved)
    assert shapes == sorted([(n, h), (vocab, h), (vocab,), (n,), (n,),
                             (n,), (n,)])
    small = port_ce.vocab_parallel_cross_entropy_from_hidden(
        x, torch.randn(1031, h), torch.randint(0, 1031, (n,)), chunk=256)
    assert _fused_node(small) is None
