"""The port's layer library against the JAX package's, on the CPU: ``mlp``,
``fused_dense``, ``reparameterization``, ``rnn``, ``transformer.utils``
and ``testing``.

The JAX parameters come from each JAX module's own ``init`` (or from a
numpy seed) and reach the port's modules through ``convert.
layer_from_jax``; the same numpy inputs and output gradients go through
both, forward and ``jax.vjp`` against autograd.  With one ``key`` the
port's fp32 initializers draw JAX's values bit for bit (the port's
threefry and JAX's uniform), which is checked too.

Tolerances: fp32 to 1e-5 relative (1e-5 absolute near zero), products
and sums taken in other orders; the rnn stacks over 9 time steps, whose
differences grow step by step, to 2e-5 relative.  bf16 results within
two bf16 ulps of each element (the ulp taken at no less than 2**-8 of
the tensor's largest magnitude); where a second product follows the
tanh GELU, within two ulps of the output's largest magnitude: the port's
GELU is ``F.gelu(approximate="tanh")``, which rounds once, while JAX's
rounds each of its bf16 operations (up to 3 ulps apart at the GELU), and
the product's small outputs are differences of large terms.  The stacked rnn's dropout masks are
JAX's bit for bit.
"""

import importlib
import unittest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fused_dense as jfd
from apex_tpu import mlp as jmlp
from apex_tpu import reparameterization as jrep
from apex_tpu import rnn as jrnn
from apex_tpu.transformer import utils as jutils
from apex_tpu_torch import convert
from apex_tpu_torch import fused_dense as tfd
from apex_tpu_torch import mlp as tmlp
from apex_tpu_torch import random as prng
from apex_tpu_torch import reparameterization as trep
from apex_tpu_torch import rnn as trnn
from apex_tpu_torch import testing as ttesting
from apex_tpu_torch.transformer import utils as tutils

torch.set_num_threads(1)  # the suite's parallel workers share the cores

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
RNN_TOL = dict(rtol=2e-5, atol=2e-5)


def assert_bf16_ulps(got, want, n=2, floor=2.0 ** -8):
    """Within ``n`` bf16 ulps of each element, the ulp taken at no less
    than ``floor`` of the largest magnitude (``floor=1``: the ulp of the
    largest magnitude for every element)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mag = np.maximum(np.abs(want), np.abs(got))
    mag = np.maximum(mag, np.abs(want).max() * floor)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    off = np.abs(got - want)
    assert (off <= n * ulp).all(), float((off / ulp).max())


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _torch(a, dtype=torch.float32):
    return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(dtype)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded(tree, seed, scale=0.3):
    """``tree``'s leaves redrawn from a numpy seed, dtypes kept."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(scale * rng.randn(*a.shape), a.dtype), tree)


def _grads(module):
    return {n: p.grad for n, p in module.named_parameters()}


def _check_grads(jgrads, module, tol):
    """JAX's parameter gradients (a tree) against the module's."""
    want = convert.layer_from_jax(_numpy_tree(
        jax.tree.map(lambda g: jnp.asarray(g, jnp.float32), jgrads)))
    got = _grads(module)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.float().numpy(), want[name].numpy(),
                                   **tol, err_msg=name)


# ------------------------------------------------------------------ mlp

MLP_CASES = [([24, 32, 16, 8], True, "relu"),
             ([24, 32, 8], True, "sigmoid"),
             ([16, 20, 12], False, "none"),
             ([12, 4], True, "relu")]


@pytest.mark.parametrize("sizes, bias, act", MLP_CASES,
                         ids=[f"{len(s) - 1}x-{b}-{a}"
                              for s, b, a in MLP_CASES])
def test_mlp_matches_jax(sizes, bias, act):
    jm = jmlp.MLP(sizes, bias=bias, activation=act)
    params = jm.init(jax.random.PRNGKey(1))
    tm = tmlp.MLP(sizes, bias=bias, activation=act, device="cpu")
    tm.load_state_dict(convert.layer_from_jax(_numpy_tree(params)))
    rng = np.random.RandomState(len(sizes))
    x = rng.randn(10, sizes[0]).astype(np.float32)
    dy = rng.randn(10, sizes[-1]).astype(np.float32)
    jy, vjp = jax.vjp(jm.apply, params, jnp.asarray(x))
    jgp, jdx = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx)
    ty.backward(torch.tensor(dy))
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **FP32_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jdx), **FP32_TOL)
    _check_grads(jgp, tm, FP32_TOL)
    # the functional form on the module's own layers
    again = tmlp.mlp_function(tm.layer_params(), torch.tensor(x), act)
    assert torch.equal(again, ty.detach())


def test_mlp_bf16_matches_jax():
    sizes = [32, 48, 16]
    jm = jmlp.MLP(sizes, params_dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(2))
    tm = tmlp.MLP(sizes, params_dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(convert.layer_from_jax(_numpy_tree(params)))
    x = jnp.asarray(np.random.RandomState(0).randn(8, 32), jnp.bfloat16)
    jy = jm.apply(params, x)
    ty = tm(_torch(x, torch.bfloat16))
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert_bf16_ulps(ty.detach().float().numpy(), _np(jy))


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_init_draws_jax_values(bias):
    """``key`` draws JAX's ``MLP.init(key)`` bit for bit in fp32."""
    sizes = [20, 36, 8]
    want = convert.layer_from_jax(_numpy_tree(
        jmlp.MLP(sizes, bias=bias).init(jax.random.PRNGKey(7))))
    tm = tmlp.MLP(sizes, bias=bias, device="cpu", key=prng.PRNGKey(7))
    got = tm.state_dict()
    assert list(got) == list(want) or set(got) == set(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


@pytest.mark.parametrize("sizes, act, what", [
    ([8], "relu", "at least two sizes"), ([8, 4], "gelu", "not supported")])
def test_mlp_raises_jax_type_errors(sizes, act, what):
    for make in (lambda: jmlp.MLP(sizes, activation=act),
                 lambda: tmlp.MLP(sizes, activation=act, device="cpu")):
        with pytest.raises(TypeError, match=what):
            make()


# ----------------------------------------------------------- fused dense

def _dense_pair(gelu, dtype=jnp.float32, tdtype=torch.float32, bias=True):
    if gelu:
        jm = jfd.FusedDenseGeluDense(16, 64, 24, params_dtype=dtype)
        tm = tfd.FusedDenseGeluDense(16, 64, 24, params_dtype=tdtype,
                                     device="cpu")
    else:
        jm = jfd.FusedDense(16, 24, bias=bias, params_dtype=dtype)
        tm = tfd.FusedDense(16, 24, bias=bias, params_dtype=tdtype,
                            device="cpu")
    params = jm.init(jax.random.PRNGKey(3))
    tm.load_state_dict(convert.layer_from_jax(_numpy_tree(params)))
    return jm, params, tm


@pytest.mark.parametrize("gelu, bias", [(False, True), (False, False),
                                        (True, True)],
                         ids=["dense", "dense-nobias", "dense-gelu-dense"])
def test_fused_dense_matches_jax(gelu, bias):
    jm, params, tm = _dense_pair(gelu, bias=bias)
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6, 16).astype(np.float32)
    dy = rng.randn(4, 6, 24).astype(np.float32)
    jy, vjp = jax.vjp(jm.apply, params, jnp.asarray(x))
    jgp, jdx = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx)
    ty.backward(torch.tensor(dy))
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **FP32_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jdx), **FP32_TOL)
    _check_grads(jgp, tm, FP32_TOL)


@pytest.mark.parametrize("gelu", [False, True], ids=["dense", "gelu"])
def test_fused_dense_bf16_matches_jax(gelu):
    """bf16 parameters and input; the bias cast to the product's dtype
    before the add, the tanh GELU in bf16."""
    jm, params, tm = _dense_pair(gelu, jnp.bfloat16, torch.bfloat16)
    x = jnp.asarray(np.random.RandomState(6).randn(8, 16), jnp.bfloat16)
    jy = jm.apply(params, x)
    ty = tm(_torch(x, torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    assert_bf16_ulps(ty.detach().float().numpy(), _np(jy),
                     floor=1.0 if gelu else 2.0 ** -8)


def test_fused_dense_functions_take_fp32_weights_on_bf16_input():
    rng = np.random.RandomState(9)
    x = jnp.asarray(rng.randn(5, 8), jnp.bfloat16)
    w = rng.randn(8, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    jy = jfd.fused_dense_function(x, jnp.asarray(w), jnp.asarray(b))
    ty = tfd.fused_dense_function(_torch(x, torch.bfloat16),
                                  torch.tensor(w), torch.tensor(b))
    assert ty.dtype == torch.bfloat16
    assert_bf16_ulps(ty.detach().float().numpy(), _np(jy))


@pytest.mark.parametrize("gelu", [False, True], ids=["dense", "gelu"])
def test_fused_dense_init_draws_jax_values(gelu):
    jm, params, _ = _dense_pair(gelu)
    want = convert.layer_from_jax(_numpy_tree(params))
    cls = tfd.FusedDenseGeluDense if gelu else tfd.FusedDense
    args = (16, 64, 24) if gelu else (16, 24)
    got = cls(*args, device="cpu", key=prng.PRNGKey(3)).state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


def test_fused_dense_gelu_dense_without_bias_raises_as_jax():
    for make in (lambda: jfd.FusedDenseGeluDense(4, 8, 4, bias=False),
                 lambda: tfd.FusedDenseGeluDense(4, 8, 4, bias=False,
                                                 device="cpu")):
        with pytest.raises(RuntimeError, match="without bias"):
            make()


# ------------------------------------------------------ reparameterization

@pytest.mark.parametrize("dim", [0, 1, None])
@pytest.mark.parametrize("shape", [(6, 10), (3, 3, 4, 5)])
def test_weight_norm_matches_jax(shape, dim):
    rng = np.random.RandomState(len(shape))
    w = rng.randn(*shape).astype(np.float32)
    jwn = jrep.weight_norm_init(jnp.asarray(w), dim)
    twn = trep.weight_norm_init(torch.tensor(w), dim)
    np.testing.assert_allclose(twn["g"].numpy(), _np(jwn["g"]), **FP32_TOL)
    assert twn["g"].shape == jwn["g"].shape
    g = (1.0 + 0.5 * rng.randn(*jwn["g"].shape)).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    jw, vjp = jax.vjp(lambda wn: jrep.compute_weight(wn, dim),
                      {"g": jnp.asarray(g), "v": jnp.asarray(v)})
    (jgrad,) = vjp(jnp.asarray(dy))
    tg = torch.tensor(g, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    tw = trep.compute_weight({"g": tg, "v": tv}, dim)
    tw.backward(torch.tensor(dy))
    np.testing.assert_allclose(tw.detach().numpy(), _np(jw), **FP32_TOL)
    np.testing.assert_allclose(tg.grad.numpy(), _np(jgrad["g"]), **FP32_TOL)
    np.testing.assert_allclose(tv.grad.numpy(), _np(jgrad["v"]), **FP32_TOL)
    back = trep.remove_weight_norm({"g": tg, "v": tv}, dim)
    assert torch.equal(back, tw)


def test_weight_norm_bf16_and_the_zero_floor_match_jax():
    rng = np.random.RandomState(1)
    v = jnp.asarray(rng.randn(8, 16), jnp.bfloat16).at[3].set(0)
    g = jnp.asarray(rng.rand(8, 1) + 0.5, jnp.bfloat16)
    jw = jrep.compute_weight({"g": g, "v": v}, 0)
    tw = trep.compute_weight({"g": _torch(g, torch.bfloat16),
                              "v": _torch(v, torch.bfloat16)}, 0)
    assert tw.dtype == torch.bfloat16 and jw.dtype == jnp.bfloat16
    assert (tw[3] == 0).all() and torch.isfinite(tw).all()
    assert_bf16_ulps(tw.float().numpy(), _np(jw))
    jg = jrep.weight_norm_init(v, 0)["g"]
    tg = trep.weight_norm_init(_torch(v, torch.bfloat16), 0)["g"]
    assert tg.dtype == torch.bfloat16
    assert_bf16_ulps(tg.float().numpy(), _np(jg))


def test_apply_weight_norm_walks_the_tree_as_jax():
    """A nested dict with a list: every ``weight`` becomes ``{"g", "v"}``,
    the rest stays, as JAX's pytree walk does; a state dict's dotted
    names are matched on their last part."""
    rng = np.random.RandomState(2)
    tree = {"fc": {"weight": rng.randn(4, 6).astype(np.float32),
                   "bias": rng.randn(6).astype(np.float32)},
            "blocks": [{"weight": rng.randn(3, 3).astype(np.float32)}],
            "scale": rng.randn(2).astype(np.float32)}
    jout = jrep.apply_weight_norm(jax.tree.map(jnp.asarray, tree), dim=1)
    tout = trep.apply_weight_norm(jax.tree.map(torch.tensor, tree), dim=1)
    assert jax.tree.structure(tout) == jax.tree.structure(jout)
    for a, b in zip(jax.tree.leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_allclose(a.numpy(), _np(b), **FP32_TOL)
    state = {"fc.weight": torch.tensor(tree["fc"]["weight"]),
             "fc.bias": torch.tensor(tree["fc"]["bias"])}
    flat = trep.apply_weight_norm(state, dim=1)
    assert set(flat) == {"fc.weight", "fc.bias"}
    assert set(flat["fc.weight"]) == {"g", "v"}
    assert flat["fc.bias"] is state["fc.bias"]
    np.testing.assert_allclose(flat["fc.weight"]["g"].numpy(),
                               _np(jout["fc"]["weight"]["g"]), **FP32_TOL)


# --------------------------------------------------------------------- rnn

RNN_CASES = [("Tanh", 1, False), ("ReLU", 2, False), ("LSTM", 2, False),
             ("LSTM", 1, True), ("GRU", 2, False), ("GRU", 1, True),
             ("mLSTM", 2, False), ("mLSTM", 1, True)]
SEQ, BATCH, IN, HID = 9, 3, 6, 8


def _rnn_pair(kind, layers, bidir, dropout=0.0, **kw):
    jm = getattr(jrnn, kind)(IN, HID, num_layers=layers, bidirectional=bidir,
                             dropout=dropout, **kw)
    tm = getattr(trnn, kind)(IN, HID, num_layers=layers, bidirectional=bidir,
                             dropout=dropout, device="cpu", **kw)
    params = _seeded(jm.init(jax.random.PRNGKey(4)), layers + 3 * bidir,
                     scale=0.4)
    tm.load_state_dict(convert.layer_from_jax(_numpy_tree(params)))
    return jm, params, tm


@pytest.mark.parametrize("kind, layers, bidir", RNN_CASES,
                         ids=[f"{k}-{n}-{'bi' if b else 'uni'}"
                              for k, n, b in RNN_CASES])
def test_rnn_stack_matches_jax(kind, layers, bidir):
    """9 time steps through the stack, forward and every gradient."""
    jm, params, tm = _rnn_pair(kind, layers, bidir)
    rng = np.random.RandomState(11)
    xs = rng.randn(SEQ, BATCH, IN).astype(np.float32)
    d = 2 if bidir else 1
    dy = rng.randn(SEQ, BATCH, HID * d).astype(np.float32)
    jy, vjp = jax.vjp(jm.apply, params, jnp.asarray(xs))
    jgp, jdx = vjp(jnp.asarray(dy))
    tx = torch.tensor(xs, requires_grad=True)
    ty = tm(tx)
    ty.backward(torch.tensor(dy))
    assert ty.shape == (SEQ, BATCH, HID * d)
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **RNN_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jdx), **RNN_TOL)
    _check_grads(jgp, tm, RNN_TOL)


@pytest.mark.parametrize("kind", ["Tanh", "LSTM", "GRU", "mLSTM"])
def test_rnn_cell_carry_matches_jax(kind):
    """One cell from a given carry: the final carry and the outputs."""
    jm, params, tm = _rnn_pair(kind, 1, False)
    jcell, tcell = jm.cells[0], tm._modules["0"]
    rng = np.random.RandomState(12)
    xs = rng.randn(SEQ, BATCH, IN).astype(np.float32)
    h0 = rng.randn(BATCH, HID).astype(np.float32)
    two = jcell.n_hidden_states == 2
    jcarry = (jnp.asarray(h0), jnp.asarray(0.5 * h0)) if two else \
        jnp.asarray(h0)
    tcarry = (torch.tensor(h0), torch.tensor(0.5 * h0)) if two else \
        torch.tensor(h0)
    jc, jy = jcell.apply(params[0], jnp.asarray(xs), jcarry)
    tc, ty = tcell(torch.tensor(xs), tcarry)
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **RNN_TOL)
    for a, b in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), **RNN_TOL)


@pytest.mark.parametrize("kind", ["LSTM", "GRU", "mLSTM"])
def test_rnn_init_draws_jax_values(kind):
    """The stack's ``key`` draws JAX's ``init(key)`` bit for bit: the
    per-cell key splits, the uniform weights, the LSTMs' forget-gate
    bias fill (gates ``(i, f, g, o)``)."""
    jm = getattr(jrnn, kind)(IN, HID, num_layers=2, forget_bias=2.5)
    want = convert.layer_from_jax(_numpy_tree(jm.init(
        jax.random.PRNGKey(5))))
    tm = getattr(trnn, kind)(IN, HID, num_layers=2, forget_bias=2.5,
                             device="cpu", key=prng.PRNGKey(5))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
    if kind != "GRU":
        assert (got["0.bias"][HID:2 * HID] == 2.5).all()
        assert (got["0.bias"][:HID] == 0).all()


def test_gru_has_one_input_bias_unlike_torch_gru():
    """JAX's GRU: one bias of ``3 h`` on the input gates, none inside the
    reset product (``nn.GRU`` has a second, ``b_hn``)."""
    tm = trnn.GRU(IN, HID, device="cpu")
    assert dict((n, tuple(p.shape)) for n, p in tm.named_parameters()) == {
        "0.w_ih": (IN, 3 * HID), "0.w_hh": (HID, 3 * HID),
        "0.bias": (3 * HID,)}


def test_rnn_dropout_masks_are_jax_bit_for_bit():
    """Dropout between layers from one ``rng``: JAX splits the key a
    layer and draws ``bernoulli(sub, 1 - p)``; the port's stack sends the
    same key to ``ops.dropout``, so the zeros fall where JAX's do."""
    jm, params, tm = _rnn_pair("LSTM", 3, False, dropout=0.3)
    xs = np.random.RandomState(13).randn(SEQ, BATCH, IN).astype(np.float32)
    key = jax.random.PRNGKey(21)
    jcells = jm.cells
    # JAX's first two layers with their masks, one by one
    h = jnp.asarray(xs)
    th = torch.tensor(xs)
    rng, trng = key, prng.key_from_jax(np.asarray(key))
    for layer in range(2):
        _, h = jcells[layer].apply(params[layer], h)
        rng, sub = jax.random.split(rng)
        keep = np.asarray(jax.random.bernoulli(sub, 0.7, h.shape))
        _, th = tm._modules[str(layer)](th)
        trng, tsub = prng.split(trng)
        tkept = trnn.dropout(th, tsub, 0.3) != 0
        assert (tkept.numpy() == (keep & (np.asarray(h) != 0))).all()
        h = jnp.where(keep, h / 0.7, 0.0)
        th = trnn.dropout(th, tsub, 0.3)
    jy = jm.apply(params, jnp.asarray(xs), rng=key)
    ty = tm(torch.tensor(xs), rng=prng.key_from_jax(np.asarray(key)))
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **RNN_TOL)
    # without a key, no dropout, as in JAX
    np.testing.assert_allclose(tm(torch.tensor(xs)).detach().numpy(),
                               _np(jm.apply(params, jnp.asarray(xs))),
                               **RNN_TOL)


# ------------------------------------------------------ transformer.utils

@pytest.mark.parametrize("num, den", [(12, 4), (12, 5), (0, 3)])
def test_divide_matches_jax(num, den):
    if num % den:
        msgs = []
        for f in (jutils.divide, tutils.divide):
            with pytest.raises(ValueError) as err:
                f(num, den)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    else:
        assert tutils.divide(num, den) == jutils.divide(num, den)
        tutils.ensure_divisibility(num, den)


def test_split_and_gather_at_one_rank_are_the_flat_tensor():
    x = torch.arange(24.0).reshape(2, 3, 4)
    chunk = tutils.split_tensor_into_1d_equal_chunks(x)
    assert torch.equal(chunk, x.reshape(-1))
    assert torch.equal(tutils.gather_split_1d_tensor(chunk), x.reshape(-1))
    assert set(jutils.__all__) == set(tutils.__all__)


@pytest.mark.parametrize("fn", ["split_tensor_into_1d_equal_chunks",
                                "gather_split_1d_tensor"])
def test_split_and_gather_over_ranks_wait_for_item_9(monkeypatch, fn):
    """Over two tensor-parallel ranks (item 9a, now ported) the split is
    rank 1's contiguous chunk and the gather all-gathers the chunks, here
    through a stand-in for ``torch.distributed.all_gather`` that hands
    each rank's slot its own copy (the spawned two-rank runs are in
    ``tests/test_torch_tensor_parallel.py``)."""
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.tensor_parallel import mappings

    monkeypatch.setattr(parallel_state,
                        "get_tensor_model_parallel_world_size", lambda: 2)
    monkeypatch.setattr(parallel_state,
                        "get_tensor_model_parallel_rank", lambda: 1)
    calls = []

    def all_gather(parts, x, group=None):
        calls.append(len(parts))
        for i, part in enumerate(parts):
            part.copy_(x + 100 * i)

    monkeypatch.setattr(mappings.dist, "all_gather", all_gather)
    x = torch.arange(8.0)
    got = getattr(tutils, fn)(x)
    if fn == "split_tensor_into_1d_equal_chunks":
        assert torch.equal(got, x[4:]) and not calls
    else:
        assert torch.equal(got, torch.cat([x, x + 100])) and calls == [2]


@pytest.mark.parametrize("fn", ["split_tensor_into_1d_equal_chunks",
                                "gather_split_1d_tensor"])
def test_split_and_gather_in_a_data_parallel_world_are_the_flat_tensor(
        monkeypatch, fn):
    """A ``torch.distributed`` world of two data-parallel ranks keeps one
    tensor-parallel rank, where JAX's size of the ``tp`` axis is 1."""
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    x = torch.arange(8.0).reshape(2, 4)
    assert torch.equal(getattr(tutils, fn)(x), x.reshape(-1))


# ---------------------------------------------------------------- testing

def test_testing_flag_reads_its_variable(monkeypatch):
    monkeypatch.setenv("APEX_TPU_TORCH_TEST_WITH_GPU", "1")
    assert importlib.reload(ttesting).TEST_WITH_GPU is True
    monkeypatch.delenv("APEX_TPU_TORCH_TEST_WITH_GPU")
    assert importlib.reload(ttesting).TEST_WITH_GPU is False


@pytest.mark.parametrize("capability, runs", [((9, 0), True),
                                              ((8, 0), False)])
def test_skip_if_no_gpu_wants_hopper(monkeypatch, capability, runs):
    calls = []
    fn = ttesting.skipIfNoGpu(lambda: calls.append(1))
    with pytest.raises(unittest.SkipTest):
        fn()  # no CUDA here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: capability)
    if runs:
        fn()
        assert calls == [1]
    else:
        with pytest.raises(unittest.SkipTest, match="sm_90"):
            fn()


def test_skip_if_cpu(monkeypatch):
    calls = []
    fn = ttesting.skipIfCpu(lambda x: calls.append(x))
    with pytest.raises(unittest.SkipTest, match="CPU"):
        fn(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fn(2)
    assert calls == [2]


# ------------------------------------------------------------ the device

def test_layer_modules_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tmlp.MLP([4, 4]),
                 lambda: tfd.FusedDense(4, 4),
                 lambda: tfd.FusedDenseGeluDense(4, 8, 4),
                 lambda: trnn.LSTM(4, 4), lambda: trnn.mLSTM(4, 4),
                 lambda: trnn.StackedRNN(trnn._GRUCell, 4, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
