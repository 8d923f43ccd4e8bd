"""The port's ``contrib.xentropy`` against the JAX package's.

The same numpy logits and labels go through
``apex_tpu.contrib.xentropy`` and ``apex_tpu_torch.contrib.xentropy``;
the gradient is that of ``sum(weights * loss)``, by ``jax.grad`` and by
``torch.autograd`` through each side's custom backward.

Tolerances: fp32 logits, losses and gradients to 1e-5 absolute and
relative (log-sum-exp in another order).  bf16 logits: both sides compute
in fp32 from the same bf16 values and round once, so the bf16 loss
(``half_to_float=False``) and gradient are within one bf16 ulp of their
largest value (2**-7 of it), and the fp32 loss (``half_to_float=True``)
to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import xentropy as jax_x
from apex_tpu_torch.contrib import xentropy as port_x

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, shape=(4, 6), vocab=50):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(*shape, vocab)).astype(np.float32)
    labels = rng.randint(0, vocab, shape).astype(np.int32)
    labels.reshape(-1)[:2] = 0       # the default padding_idx
    weights = rng.rand(*shape).astype(np.float32)
    return logits, labels, weights


def _jax(fn, logits, labels, weights, bf16):
    def total(lg):
        loss = fn(lg, jnp.asarray(labels))
        return jnp.sum(loss.astype(jnp.float32) * weights), loss

    lg = jnp.asarray(logits)
    if bf16:
        lg = lg.astype(jnp.bfloat16)
    (_, loss), grad = jax.value_and_grad(total, has_aux=True)(lg)
    return (np.asarray(loss.astype(jnp.float32)), loss.dtype,
            np.asarray(grad.astype(jnp.float32)))


def _port(fn, logits, labels, weights, bf16):
    lg = torch.from_numpy(logits)
    if bf16:
        lg = lg.bfloat16()
    lg.requires_grad_()
    loss = fn(lg, torch.from_numpy(labels))
    (loss.float() * torch.from_numpy(weights)).sum().backward()
    return loss.detach().float().numpy(), loss.dtype, lg.grad.float().numpy()


def _close(got, want, bf16_rounded):
    if bf16_rounded:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype, half_to_float",
                         [("float32", False), ("bfloat16", False),
                          ("bfloat16", True)])
def test_loss_and_grad_match_jax(smoothing, dtype, half_to_float):
    logits, labels, weights = _inputs(int(100 * smoothing) + 1)
    bf16 = dtype == "bfloat16"
    want, want_dtype, want_g = _jax(
        lambda lg, lb: jax_x.softmax_cross_entropy_loss(
            lg, lb, smoothing, half_to_float), logits, labels, weights, bf16)
    got, got_dtype, got_g = _port(
        lambda lg, lb: port_x.softmax_cross_entropy_loss(
            lg, lb, smoothing, half_to_float), logits, labels, weights, bf16)
    assert str(got_dtype).replace("torch.", "") == str(want_dtype)
    _close(got, want, bf16 and not half_to_float)
    _close(got_g, want_g, bf16)


@pytest.mark.parametrize("padding_idx", [0, None, 7])
def test_module_masks_padding_as_jax(padding_idx):
    logits, labels, weights = _inputs(3)
    labels[1, 3] = 7
    want, _, want_g = _jax(jax_x.SoftmaxCrossEntropyLoss(
        smoothing=0.1, padding_idx=padding_idx), logits, labels, weights,
        False)
    got, _, got_g = _port(port_x.SoftmaxCrossEntropyLoss(
        smoothing=0.1, padding_idx=padding_idx), logits, labels, weights,
        False)
    _close(got, want, False)
    _close(got_g, want_g, False)
    if padding_idx is not None:
        assert (got[labels == padding_idx] == 0).all()


def test_backward_is_the_kernel_form():
    """d loss / d logits = softmax - (1-s) onehot - s/V, times the
    upstream gradient."""
    logits, labels, _ = _inputs(5, shape=(3,), vocab=11)
    lg = torch.from_numpy(logits).requires_grad_()
    g = torch.tensor([1.0, -2.0, 0.5])
    (port_x.softmax_cross_entropy_loss(lg, torch.from_numpy(labels), 0.2)
     * g).sum().backward()
    onehot = torch.nn.functional.one_hot(torch.from_numpy(labels).long(), 11)
    want = (torch.softmax(torch.from_numpy(logits), -1) - 0.8 * onehot
            - 0.2 / 11) * g[:, None]
    torch.testing.assert_close(lg.grad, want)
