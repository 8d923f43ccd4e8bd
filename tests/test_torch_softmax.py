"""The port's fused scale-mask-softmax against the JAX package.

The same numpy scores, masks and output cotangents go through
``apex_tpu.ops.softmax`` (``implementation="pallas"``, the
``_softmax_fwd_kernel`` body in interpret mode on the CPU, where it has a
Pallas kernel; ``"xla"`` always) and through ``apex_tpu_torch.ops.softmax``
on CPU tensors (the Triton kernel's plain version), forward and gradient
(``jax.grad`` / autograd), and the same for the two packages'
``FusedScaleMaskSoftmax`` (padding and causal, with and without a mask,
with a ``mask_func``).  A padding mask of shape ``(b, 1, sq, sk)`` masks
one query row fully: its softmax is uniform (the -10000 fill, not -inf).

Tolerances: fp32 1e-6 (fp32 statistics on both sides, sums in another
order); bf16 one bf16 ulp at the tensor's largest magnitude (both compute
in fp32 and round once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import softmax as jsm
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as JaxFused,
)
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

torch.set_num_threads(1)  # the suite's parallel workers share the cores

B, NP, SQ, SK = 2, 3, 8, 16
SCALE = 0.7
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(B, NP, SQ, SK)).astype(np.float32)
    dy = rng.randn(B, NP, SQ, SK).astype(np.float32)
    mask = rng.rand(B, 1, SQ, SK) < 0.3
    mask[1, 0, 2, :] = True                 # one fully masked query row
    return x, dy, mask


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp


def _port_fwd_bwd(fn, x, dy, tdt):
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = fn(xt)
    y.backward(torch.from_numpy(dy).to(tdt))
    return y.detach(), xt.grad


def _jax_fwd_bwd(fn, x, dy, jdt):
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    y, vjp = jax.vjp(fn, xj)
    return y, vjp(dyj)[0]


VARIANTS = {
    "scaled": (lambda x: tsm.scaled_softmax(x, SCALE),
               lambda impl: lambda x: jsm.scaled_softmax(x, SCALE, impl),
               ("pallas", "xla")),
    "causal": (lambda x: tsm.scaled_upper_triang_masked_softmax(x, SCALE),
               lambda impl: lambda x: jsm.scaled_upper_triang_masked_softmax(
                   x, SCALE, impl),
               ("pallas", "xla")),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_unmasked_variants_match_pallas_and_xla(name, dtype):
    tdt, jdt = DTYPES[dtype]
    x, dy, _ = _inputs(1)
    port_fn, jax_fn, impls = VARIANTS[name]
    y, dx = _port_fwd_bwd(port_fn, x, dy, tdt)
    assert y.dtype == tdt and dx.dtype == tdt
    for impl in impls:
        jy, jdx = _jax_fwd_bwd(jax_fn(impl), x, dy, jdt)
        _close(y, jy, dtype)
        _close(dx, jdx, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_masked_softmax_matches_xla(causal, dtype):
    tdt, jdt = DTYPES[dtype]
    x, dy, mask = _inputs(2)
    y, dx = _port_fwd_bwd(
        lambda t: tsm.scaled_masked_softmax(t, torch.from_numpy(mask), SCALE,
                                            causal=causal), x, dy, tdt)
    jy, jdx = _jax_fwd_bwd(
        lambda t: jsm.scaled_masked_softmax(t, jnp.asarray(mask), SCALE,
                                            causal=causal,
                                            implementation="xla"),
        x, dy, jdt)
    _close(y, jy, dtype)
    _close(dx, jdx, dtype)
    # the fully masked row is uniform, not NaN
    row = y[1, :, 2].float()
    torch.testing.assert_close(row, torch.full_like(row, 1.0 / SK),
                               rtol=0, atol=2e-3)


def _mask_func(scores, mask):
    return scores.masked_fill(mask, -5000.0) if isinstance(
        scores, torch.Tensor) else jnp.where(mask, -5000.0, scores)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask_type, with_mask, mask_func", [
    ("padding", False, False), ("padding", True, False),
    ("padding", True, True), ("causal", False, False),
    ("causal", True, False)])
def test_fused_scale_mask_softmax_matches_jax(mask_type, with_mask,
                                              mask_func, dtype):
    tdt, jdt = DTYPES[dtype]
    x, dy, mask = _inputs(3)
    kw = dict(input_in_bf16=dtype == "bfloat16", scale=SCALE,
              mask_func=_mask_func if mask_func else None)
    port = FusedScaleMaskSoftmax(
        attn_mask_type=getattr(AttnMaskType, mask_type), **kw)
    ref = JaxFused(attn_mask_type=getattr(JaxMaskType, mask_type), **kw)
    tmask = torch.from_numpy(mask) if with_mask else None
    jmask = jnp.asarray(mask) if with_mask else None
    y, dx = _port_fwd_bwd(lambda t: port(t, tmask), x, dy, tdt)
    jy, jdx = _jax_fwd_bwd(lambda t: ref(t, jmask), x, dy, jdt)
    _close(y, jy, dtype)
    _close(dx, jdx, dtype)


def test_kernel_availability_follows_the_device():
    f = FusedScaleMaskSoftmax(input_in_bf16=True)
    assert not f.is_kernel_available(None, B, NP, SQ, SK, device="cpu")
    assert f.is_kernel_available(None, B, NP, SQ, SK, device="cuda:0")
    assert not FusedScaleMaskSoftmax(input_in_bf16=False).is_kernel_available(
        None, B, NP, SQ, SK, device="cuda:0")
    with pytest.raises(RuntimeError, match="both fp16 and bf16"):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(ValueError, match=r"\(b, np, sq, sk\)"):
        f(torch.zeros(SQ, SK), None)


def test_three_dim_scores_and_a_bad_mask():
    """The functions take ``(..., sq, sk)`` scores; a mask that does not
    broadcast raises."""
    x, _, _ = _inputs(4)
    x3 = torch.from_numpy(x[0])
    want = jsm.scaled_softmax(jnp.asarray(x[0]), SCALE, "xla")
    _close(tsm.scaled_softmax(x3, SCALE), want, "float32")
    with pytest.raises(RuntimeError):
        tsm.scaled_masked_softmax(x3, torch.zeros(5, SK, dtype=torch.bool))
