"""``apex_tpu_torch.contrib.multihead_attn`` against the JAX package's
``apex_tpu.contrib.multihead_attn``.

Both modules are built at small widths (embed 32, 4 heads of 8, which the
port's attention pads to 64 and JAX's flash rung to 128 lanes) and loaded
with the same parameters: the JAX tree from ``init(PRNGKey(seed))`` goes
through ``convert.params_from_jax`` into the port module strictly, and the
port's own init from the same key draws the same fp32 bits.  The same
numpy inputs, masks and cotangent, and the same key for dropout, go
through the JAX ``apply`` with ``jax.vjp`` and the port's ``forward`` on
CPU tensors with ``torch.autograd``; outputs and the gradients of every
parameter and input are compared.  ``impl="fast"`` is held against JAX's
``impl="fast"`` with the same forced rung (the Pallas bodies in interpret
mode), ``impl="default"`` against JAX's ``mha_reference`` path.

Tolerances: fp32 everywhere, products summed in other orders; outputs to
2e-5 and gradients (sums over the batch and sequence) to 1e-4, relative
and absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import EncdecMultiheadAttn as JaxEncdec
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JaxSelf
from apex_tpu_torch import convert
from apex_tpu_torch import random as prng
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)

torch.set_num_threads(1)  # the suite's parallel workers share the cores

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
E, HEADS, B = 32, 4, 2


def jax_tree(module, seed):
    return module.init(jax.random.PRNGKey(seed))


def port_module(cls, seed, **kw):
    """A port module whose parameters are the JAX tree's, loaded
    strictly."""
    jcls = JaxSelf if cls is SelfMultiheadAttn else JaxEncdec
    tree = jax_tree(jcls(E, HEADS, **kw), seed)
    m = cls(E, HEADS, device="cpu", **kw)
    m.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, tree)), strict=True)
    return m, tree


def jax_grads(module, tree, inputs, dout, **kw):
    """``(out, grads of the tree, grads of the inputs)`` of the JAX
    ``apply`` under the cotangent ``dout``."""
    def f(p, *xs):
        return module.apply(p, *xs, **kw)

    out, vjp = jax.vjp(f, tree, *map(jnp.asarray, inputs))
    g = vjp(jnp.asarray(dout))
    return (np.asarray(out), jax.tree.map(np.asarray, g[0]),
            [np.asarray(x) for x in g[1:]])


def port_grads(m, inputs, dout, **kw):
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = m(*xs, **kw)
    out.backward(torch.from_numpy(dout))
    grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
    return out.detach().numpy(), grads, [x.grad.numpy() for x in xs]


def compare(got, want):
    got_out, got_p, got_x = got
    want_out, want_p, want_x = want
    np.testing.assert_allclose(got_out, want_out, **OUT_TOL)
    flat = convert.params_from_jax(want_p)
    assert set(flat) == set(got_p)
    for name, g in got_p.items():
        np.testing.assert_allclose(g, flat[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
    for i, (g, w) in enumerate(zip(got_x, want_x)):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"input {i}")


def masks(kind, s, seed):
    """``(attn_mask, key_padding_mask)`` numpy arrays of a mask kind."""
    rng = np.random.RandomState(seed)
    attn = pad = None
    if kind in ("bool", "bool+pad"):
        attn = np.triu(np.ones((s, s), bool), 1)       # the future mask
    if kind == "float":
        attn = (0.5 * rng.randn(B, 1, s, s)).astype(np.float32)
    if kind == "head":                                  # a per-head bias
        attn = (0.5 * rng.randn(B, HEADS, s, s)).astype(np.float32)
    if kind in ("pad", "bool+pad"):
        pad = np.zeros((B, s), bool)
        pad[1, s * 2 // 3:] = True
    return attn, pad


SELF_CASES = [  # (impl, rung, bias, norm_add, mask kind, causal, dropout)
    ("fast", "short", True, True, "bool", False, 0.0),
    ("fast", "short", False, False, "float", False, 0.2),
    ("fast", "short", True, False, "pad", True, 0.2),
    ("fast", "short", True, True, "bool+pad", False, 0.2),
    ("fast", "short", True, False, "head", False, 0.2),
    ("fast", "mid", True, True, "float", True, 0.0),
    ("fast", "pallas", False, True, "bool+pad", False, 0.2),
    ("default", None, True, True, "bool+pad", False, 0.2),
    ("default", None, False, False, "float", True, 0.0),
]


@pytest.mark.parametrize("impl, rung, bias, norm_add, kind, causal, rate",
                         SELF_CASES)
def test_self_attention_matches_jax(impl, rung, bias, norm_add, kind,
                                    causal, rate):
    s = 16
    kw = dict(bias=bias, include_norm_add=norm_add, impl=impl,
              attention_impl=rung, dropout=rate)
    m, tree = port_module(SelfMultiheadAttn, 1, **kw)
    jm = JaxSelf(E, HEADS, **kw)
    rng = np.random.RandomState(len(kind) + s)
    x = rng.randn(s, B, E).astype(np.float32)
    dout = rng.randn(s, B, E).astype(np.float32)
    attn, pad = masks(kind, s, 3)
    key = jax.random.PRNGKey(11)
    want = jax_grads(jm, tree, [x], dout,
                     attn_mask=None if attn is None else jnp.asarray(attn),
                     key_padding_mask=None if pad is None
                     else jnp.asarray(pad), causal=causal, rng=key)
    got = port_grads(m, [x], dout,
                     attn_mask=None if attn is None
                     else torch.from_numpy(attn),
                     key_padding_mask=None if pad is None
                     else torch.from_numpy(pad), causal=causal,
                     rng=prng.key_from_jax(key))
    compare(got, want)


@pytest.mark.parametrize("impl, rung, bias, norm_add, rate", [
    ("fast", "short", True, True, 0.2),
    ("fast", "pallas", False, False, 0.0),
    ("default", None, True, False, 0.2),
])
def test_encdec_attention_matches_jax(impl, rung, bias, norm_add, rate):
    """sq = 6 queries against sk = 10 keys (the JAX test's shape), the key
    padding of the second row, dropout from one key."""
    sq, sk = 6, 10
    kw = dict(bias=bias, include_norm_add=norm_add, impl=impl,
              attention_impl=rung, dropout=rate)
    m, tree = port_module(EncdecMultiheadAttn, 2, **kw)
    jm = JaxEncdec(E, HEADS, **kw)
    rng = np.random.RandomState(5)
    q = rng.randn(sq, B, E).astype(np.float32)
    kv = rng.randn(sk, B, E).astype(np.float32)
    dout = rng.randn(sq, B, E).astype(np.float32)
    pad = np.zeros((B, sk), bool)
    pad[1, 7:] = True
    key = jax.random.PRNGKey(4)
    want = jax_grads(jm, tree, [q, kv], dout,
                     key_padding_mask=jnp.asarray(pad), rng=key)
    got = port_grads(m, [q, kv], dout, key_padding_mask=torch.from_numpy(pad),
                     rng=prng.key_from_jax(key))
    compare(got, want)


@pytest.mark.parametrize("cls", [SelfMultiheadAttn, EncdecMultiheadAttn])
@pytest.mark.parametrize("bias, norm_add", [(False, False), (True, True)])
def test_init_draws_the_jax_parameters(cls, bias, norm_add):
    """The port's init from a key is JAX ``init`` from the same key, bit
    for bit in fp32, and names every leaf of the tree (a strict load)."""
    jcls = JaxSelf if cls is SelfMultiheadAttn else JaxEncdec
    kw = dict(bias=bias, include_norm_add=norm_add)
    tree = convert.params_from_jax(jax.tree.map(
        np.asarray, jax_tree(jcls(E, HEADS, **kw), 7)))
    m = cls(E, HEADS, device="cpu", key=prng.PRNGKey(7), **kw)
    state = m.state_dict()
    assert set(state) == set(tree)
    for name, t in tree.items():
        assert torch.equal(state[name], t), name
    m.load_state_dict(tree, strict=True)


def test_fast_matches_default_and_dropout_is_the_same_mask():
    """The reference's own cross-check (``impl="fast"`` == ``"default"``,
    tests/test_contrib.py:135-148) on the port, here with a bias, padding
    and dropout: one key draws one mask on both paths; another key, or no
    key, another output."""
    s = 16
    x = torch.from_numpy(np.random.RandomState(1).randn(s, B, E).astype(
        np.float32))
    attn, pad = (torch.from_numpy(a) for a in masks("bool+pad", s, 2))
    outs = {}
    for impl in ("default", "fast"):
        m = SelfMultiheadAttn(E, HEADS, dropout=0.2, bias=True, impl=impl,
                              device="cpu", key=prng.PRNGKey(0))
        outs[impl] = m(x, attn_mask=attn, key_padding_mask=pad,
                       rng=prng.PRNGKey(3))
        assert not torch.allclose(outs[impl], m(
            x, attn_mask=attn, key_padding_mask=pad, rng=prng.PRNGKey(4)))
        torch.testing.assert_close(
            m(x, attn_mask=attn, key_padding_mask=pad, is_training=False),
            m(x, attn_mask=attn, key_padding_mask=pad))
    torch.testing.assert_close(outs["fast"], outs["default"], **OUT_TOL)


def test_padding_and_norm_add_behave_as_in_jax():
    """Padded keys change nothing they may not see, and with the output
    projection zeroed the norm-add variant returns its input
    (tests/test_contrib.py:150-180, on the port)."""
    s = 8
    x = torch.from_numpy(np.random.RandomState(1).randn(s, B, 16).astype(
        np.float32))
    m = SelfMultiheadAttn(16, 4, device="cpu")
    pad = torch.zeros((B, s), dtype=torch.bool)
    pad[:, 4:] = True
    y = m(x, key_padding_mask=pad)
    x2 = x.clone()
    x2[6] += 10.0
    torch.testing.assert_close(m(x2, key_padding_mask=pad)[:4], y[:4],
                               rtol=1e-5, atol=1e-5)
    m = SelfMultiheadAttn(16, 4, include_norm_add=True, bias=True,
                          device="cpu")
    with torch.no_grad():
        m.out_weight.zero_()
    torch.testing.assert_close(m(x), x, rtol=0, atol=1e-6)


def test_constructor_checks():
    with pytest.raises(ValueError, match="divisible"):
        SelfMultiheadAttn(30, 4, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        SelfMultiheadAttn(32, 4, impl="cuda", device="cpu")
    with pytest.raises(NotImplementedError, match="'xla'"):
        EncdecMultiheadAttn(32, 4, attention_impl="xla", device="cpu")
    from apex_tpu_torch.amp import get_policy

    m = SelfMultiheadAttn(32, 4, include_norm_add=True, bias=True,
                          policy=get_policy("O5"), device="cpu")
    assert m.qkv_weight.dtype == torch.bfloat16
    assert m.lyr_nrm.scale.dtype == torch.float32
    # O2, ported since: fp16 weights, an fp32 norm
    m = SelfMultiheadAttn(32, 4, include_norm_add=True,
                          policy=get_policy("O2"), device="cpu")
    assert m.qkv_weight.dtype == torch.float16
    assert m.lyr_nrm.scale.dtype == torch.float32
