"""The port's contrib layers against the JAX package's, on the CPU:
``layer_norm``, ``groupbn``, ``bottleneck``, ``transducer`` and
``sparsity``.

The JAX parameters come from each JAX module's ``init`` and reach the
port through ``convert.layer_from_jax``; the same numpy inputs and
output gradients go through both, forward and ``jax.vjp`` against
autograd (under ``jax.jit`` for the transducer loss and the bottleneck,
whose eager JAX runs compile op by op).

Tolerances: fp32 outputs and gradients to 1e-5 relative (1e-5 absolute
near zero), the sums of the statistics, convolutions and log-space
recursions taken in other orders, and 1e-4 relative for the
bottleneck's gradients (three batch norms' backward on convolutions
whose sums run in other orders); the batch norm's running statistics to
1e-6 relative (one update from the batch's fp32 sums); bf16 within two
bf16 ulps of each element.  The transducer loss also against a brute-
force float64 sum over every alignment of a tiny lattice (1e-5
relative).  Bit for bit: the joint's dropout mask (``ops.dropout``'s
plain version, JAX's ``bernoulli``) and the 1-D and greedy sparsity
masks; the 2-D best masks equal JAX's but on the blocks whose two best
scores lie within fp32 rounding (``near_tie_blocks``), which are
counted.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import bottleneck as jbot
from apex_tpu.contrib import groupbn as jgbn
from apex_tpu.contrib import layer_norm as jfast
from apex_tpu.contrib import sparsity as jsp
from apex_tpu.contrib import transducer as jtr
from apex_tpu_torch import convert
from apex_tpu_torch import random as prng
from apex_tpu_torch.contrib import bottleneck as tbot
from apex_tpu_torch.contrib import groupbn as tgbn
from apex_tpu_torch.contrib import layer_norm as tfast
from apex_tpu_torch.contrib import sparsity as tsp
from apex_tpu_torch.contrib import transducer as ttr
from apex_tpu_torch.ops import dropout as tdrop
from apex_tpu_torch.ops.common import launch_counts

torch.set_num_threads(1)  # the suite's parallel workers share the cores

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-6, atol=1e-7)


def assert_bf16_ulps(got, want, n=2):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mag = np.maximum(np.abs(want), np.abs(got))
    mag = np.maximum(mag, np.abs(want).max() * 2.0 ** -8)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    off = np.abs(got - want)
    assert (off <= n * ulp).all(), float((off / ulp).max())


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return a.detach().float().numpy()


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ layer_norm

def test_fast_layer_norm_module_matches_jax():
    """contrib's ``FastLayerNorm`` (the layer norm kernels) forward and
    backward against JAX's (its Pallas kernel in interpret mode)."""
    jm = jfast.FastLayerNorm(96, implementation="pallas")
    rng = np.random.RandomState(0)
    variables = jax.tree.map(
        lambda a: jnp.asarray(1.0 + 0.2 * rng.randn(*a.shape), a.dtype),
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 96))))
    tm = tfast.FastLayerNorm(96, device="cpu")
    tm.load_state_dict(convert.layer_from_jax(_numpy_tree(variables)))
    x = (2 * rng.randn(4, 6, 96)).astype(np.float32)
    dy = rng.randn(4, 6, 96).astype(np.float32)
    jy, vjp = jax.vjp(lambda v, x: jm.apply(v, x), variables, jnp.asarray(x))
    jdv, jdx = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx)
    ty.backward(torch.tensor(dy))
    np.testing.assert_allclose(_t(ty), _np(jy), **FP32_TOL)
    np.testing.assert_allclose(_t(tx.grad), _np(jdx), **FP32_TOL)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(_t(getattr(tm, name).grad),
                                   _np(jdv["params"][name]), **FP32_TOL)


# --------------------------------------------------------------- groupbn

GBN_CASES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("residual, relu", GBN_CASES,
                         ids=[f"z{int(z)}-relu{int(r)}" for z, r in GBN_CASES])
def test_batch_norm_nhwc_matches_jax(residual, relu):
    rng = np.random.RandomState(3)
    x = (1.5 * rng.randn(4, 5, 6, 8) + 0.3).astype(np.float32)
    z = rng.randn(*x.shape).astype(np.float32) if residual else None
    w = (1 + 0.2 * rng.randn(8)).astype(np.float32)
    b = (0.2 * rng.randn(8)).astype(np.float32)
    rm = (0.1 * rng.randn(8)).astype(np.float32)
    rv = (1 + 0.1 * rng.rand(8)).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)

    def jf(x, w, b, z):
        return jgbn.batch_norm_nhwc(x, w, b, jnp.asarray(rm), jnp.asarray(rv),
                                    z=z, fuse_relu=relu, momentum=0.2)

    jz = None if z is None else jnp.asarray(z)
    (jy, jrm, jrv), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), jz)
    jdx, jdw, jdb, jdz = vjp((jnp.asarray(dy), jnp.zeros(8), jnp.zeros(8)))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    tz = None if z is None else torch.tensor(z, requires_grad=True)
    ty, trm, trv = tgbn.batch_norm_nhwc(
        tx, tw, tb, torch.tensor(rm), torch.tensor(rv), z=tz, fuse_relu=relu,
        momentum=0.2)
    ty.backward(torch.tensor(dy))
    np.testing.assert_allclose(_t(ty), _np(jy), **FP32_TOL)
    np.testing.assert_allclose(_t(trm), _np(jrm), **STATS_TOL)
    np.testing.assert_allclose(_t(trv), _np(jrv), **STATS_TOL)
    for got, want in ((tx, jdx), (tw, jdw), (tb, jdb)) + (
            ((tz, jdz),) if residual else ()):
        np.testing.assert_allclose(_t(got.grad), _np(want), **FP32_TOL)


def test_batch_norm_nhwc_eval_and_bf16_match_jax():
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, 4, 4, 16), jnp.bfloat16)
    w, b = (jnp.asarray(rng.randn(16), jnp.float32) for _ in range(2))
    rm = jnp.asarray(0.1 * rng.randn(16), jnp.float32)
    rv = jnp.asarray(1 + rng.rand(16), jnp.float32)
    tx = torch.tensor(_np(x)).bfloat16()
    targs = [torch.tensor(_np(a)) for a in (w, b, rm, rv)]
    for training in (True, False):
        jy, _, _ = jgbn.batch_norm_nhwc(x, w, b, rm, rv, training=training,
                                        fuse_relu=True)
        ty, _, _ = tgbn.batch_norm_nhwc(tx, *targs, training=training,
                                        fuse_relu=True)
        assert ty.dtype == torch.bfloat16
        assert_bf16_ulps(_t(ty), _np(jy))


def test_batchnorm2d_nhwc_module_matches_jax():
    """JAX's ``init`` -> ``convert`` -> the module: two training steps
    update the running-statistics buffers as JAX's new params; eval mode
    reads them; the state dict crosses back to JAX's tree."""
    jm = jgbn.BatchNorm2d_NHWC(12, fuse_relu=True, momentum=0.3)
    params = jm.init()
    tm = tgbn.BatchNorm2d_NHWC(12, fuse_relu=True, momentum=0.3,
                               device="cpu")
    tm.load_state_dict(convert.layer_from_jax(_numpy_tree(params)))
    rng = np.random.RandomState(5)
    for step in range(2):
        x = rng.randn(3, 4, 5, 12).astype(np.float32)
        z = rng.randn(3, 4, 5, 12).astype(np.float32)
        jy, params = jm.apply(params, jnp.asarray(x), jnp.asarray(z))
        ty = tm(torch.tensor(x), torch.tensor(z))
        np.testing.assert_allclose(_t(ty), _np(jy), **FP32_TOL)
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(_t(getattr(tm, name)),
                                       _np(params[name]), **STATS_TOL)
    tm.eval()
    jy, _ = jm.apply(params, jnp.asarray(x), training=False)
    np.testing.assert_allclose(_t(tm(torch.tensor(x))), _np(jy), **FP32_TOL)
    back = convert.layer_to_jax(tm.state_dict())
    assert set(back) == set(params)
    assert back["running_var"].dtype == np.float32


@pytest.mark.parametrize("make", ["function", "module"])
def test_bn_group_over_one_rank_waits_for_item_9(make):
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        if make == "module":
            tgbn.BatchNorm2d_NHWC(4, bn_group=2, device="cpu")
        else:
            tgbn.batch_norm_nhwc(torch.ones(2, 2, 2, 4), torch.ones(4),
                                 torch.zeros(4), bn_group=4)
    # bn_group 0 and 1 run on one rank
    for group in (0, 1):
        out, _, _ = tgbn.batch_norm_nhwc(torch.randn(2, 2, 2, 4),
                                         torch.ones(4), torch.zeros(4),
                                         bn_group=group)
        assert out.shape == (2, 2, 2, 4)


# ------------------------------------------------------------ bottleneck

BOT_CASES = [(8, 4, 8, 1), (8, 4, 16, 1), (16, 4, 32, 2)]


@pytest.mark.parametrize("c_in, c_mid, c_out, stride", BOT_CASES,
                         ids=["identity", "projection", "stride2"])
def test_bottleneck_matches_jax(c_in, c_mid, c_out, stride):
    jm = jbot.Bottleneck(c_in, c_mid, c_out, stride)
    params = jm.init(jax.random.PRNGKey(6))
    tm = tbot.Bottleneck(c_in, c_mid, c_out, stride, device="cpu")
    assert tm.use_proj == jm.use_proj
    tm.load_state_dict(convert.layer_from_jax(_numpy_tree(params)))
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, c_in).astype(np.float32)
    out = (2, 8 // stride, 8 // stride, c_out)
    dy = rng.randn(*out).astype(np.float32)

    @jax.jit
    def jax_fwd_bwd(params, x):
        y, vjp = jax.vjp(jm.apply, params, x)
        return (y,) + vjp(jnp.asarray(dy))

    jy, jgp, jdx = jax_fwd_bwd(params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx)
    ty.backward(torch.tensor(dy))
    assert ty.shape == jy.shape
    np.testing.assert_allclose(_t(ty), _np(jy), **FP32_TOL)
    grad_tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_t(tx.grad), _np(jdx), **grad_tol)
    want = convert.layer_from_jax(_numpy_tree(jgp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_t(p.grad), want[name].numpy(),
                                   **grad_tol, err_msg=name)
    back = convert.layer_to_jax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(
        _numpy_tree(params))


@pytest.mark.parametrize("what", ["SpatialBottleneck", "halo_exchange"])
def test_spatial_bottleneck_waits_for_item_9(what):
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        if what == "halo_exchange":
            tbot.halo_exchange(torch.ones(1, 4, 4, 2), "cp")
        else:
            tbot.SpatialBottleneck(8, 4, 8, device="cpu")


# ------------------------------------------------------------ transducer

def _transducer_inputs(b, t, u, v, seed, f_len, y_len):
    rng = np.random.RandomState(seed)
    logits = (1.5 * rng.randn(b, t, u + 1, v)).astype(np.float32)
    targets = rng.randint(1, v, (b, u)).astype(np.int32)
    return logits, targets, np.array(f_len, np.int32), \
        np.array(y_len, np.int32)


LOSS_CASES = [
    (3, 7, 5, 6, [7, 5, 1], [5, 2, 0], 0),
    (2, 12, 9, 10, [12, 12], [9, 4], 3),
    (1, 4, 1, 3, [4], [1], 0),
]


@pytest.mark.parametrize("b, t, u, v, f_len, y_len, blank", LOSS_CASES,
                         ids=["ragged", "blank3", "one-label"])
def test_transducer_loss_and_gradient_match_jax(b, t, u, v, f_len, y_len,
                                                 blank):
    logits, targets, fl, yl = _transducer_inputs(b, t, u, v, b + t, f_len,
                                                 y_len)
    dl = np.linspace(0.5, 1.5, b).astype(np.float32)

    @jax.jit
    def jax_loss_and_grad(x):
        loss, vjp = jax.vjp(lambda x: jtr.transducer_loss(
            x, targets, fl, yl, blank), x)
        return loss, vjp(jnp.asarray(dl))[0]

    jl, jg = jax_loss_and_grad(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tl = ttr.TransducerLoss()(x, torch.tensor(targets), torch.tensor(fl),
                              torch.tensor(yl), blank_idx=blank)
    tl.backward(torch.tensor(dl))
    assert tl.dtype == torch.float32 and tl.shape == (b,)
    np.testing.assert_allclose(_t(tl), _np(jl), **FP32_TOL)
    np.testing.assert_allclose(_t(x.grad), _np(jg), **FP32_TOL)


def _brute_force_nll(logits, targets, f_len, y_len, blank):
    """-log of the sum over every alignment of the lattice: from (0, 0)
    each of ``y_len`` emits moves up a label, each blank a time step, and
    the last move is the blank out of ``(f_len - 1, y_len)``; float64."""
    out = []
    for lg, tg, T, U in zip(logits.astype(np.float64), targets, f_len,
                            y_len):
        logp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
        paths = []
        for emits in itertools.combinations(range(T - 1 + U), U):
            t = u = 0
            s = 0.0
            for move in range(T - 1 + U):
                if move in emits:
                    s += logp[t, u, tg[u]]
                    u += 1
                else:
                    s += logp[t, u, blank]
                    t += 1
            paths.append(s + logp[T - 1, U, blank])
        m = max(paths)
        out.append(-(m + math.log(sum(math.exp(p - m) for p in paths))))
    return np.array(out)


def test_transducer_loss_matches_a_brute_force_lattice_sum():
    logits, targets, fl, yl = _transducer_inputs(3, 5, 3, 4, 17, [5, 3, 4],
                                                 [3, 2, 0])
    want = _brute_force_nll(logits, targets, fl, yl, 0)
    got = ttr.transducer_loss(torch.tensor(logits), torch.tensor(targets),
                              torch.tensor(fl), torch.tensor(yl))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 7, 13])
def test_associative_scan_is_lax_associative_scan(n):
    """JAX's odd-even recursion on the label axis: the same combines, so
    the same values but for the last bits of ``exp``/``log1p``."""
    rng = np.random.RandomState(n)
    a, m = (rng.randn(3, n).astype(np.float32) for _ in range(2))

    def jcomb(x, y):
        return jnp.logaddexp(y[0], x[0] + y[1]), x[1] + y[1]

    want = jax.lax.associative_scan(jcomb, (jnp.asarray(a), jnp.asarray(m)),
                                    axis=1)
    got = ttr.associative_scan(ttr._combine,
                               (torch.tensor(a), torch.tensor(m)))
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))


JOINT_CASES = [(False, 0.0, torch.float32), (True, 0.0, torch.float32),
               (True, 0.1, torch.float32), (False, 0.3, torch.float32),
               (True, 0.1, torch.bfloat16)]


@pytest.mark.parametrize("relu, rate, dtype", JOINT_CASES,
                         ids=["plain", "relu", "relu-drop", "drop",
                              "relu-drop-bf16"])
def test_transducer_joint_matches_jax_bit_for_bit(relu, rate, dtype):
    """``f[:, t] + g[:, u]``, the ReLU, and the dropout through
    ``ops.dropout`` with JAX's key: equal to JAX's joint bit for bit, the
    mask included; the CPU runs the kernel's plain version."""
    rng = np.random.RandomState(8)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    f = jnp.asarray(rng.randn(2, 5, 16), jdt)
    g = jnp.asarray(rng.randn(2, 4, 16), jdt)
    key = jax.random.PRNGKey(31)
    jh = jtr.TransducerJoint(relu=relu, dropout=rate)(f, g, rng=key)
    before = dict(launch_counts())
    th = ttr.TransducerJoint(relu=relu, dropout=rate)(
        torch.tensor(_np(f)).to(dtype), torch.tensor(_np(g)).to(dtype),
        rng=prng.key_from_jax(np.asarray(key)))
    assert dict(launch_counts()) == before
    assert th.dtype == dtype and th.shape == jh.shape
    np.testing.assert_array_equal(_t(th), _np(jh))
    if rate:
        keep = np.asarray(jax.random.bernoulli(key, 1 - rate, jh.shape))
        pre = _np(f)[:, :, None] + _np(g)[:, None]
        pre = np.maximum(pre, 0) if relu else pre
        np.testing.assert_array_equal(_t(th) != 0, keep & (pre != 0))
        mask = tdrop.dropout_mask(prng.key_from_jax(np.asarray(key)),
                                  jh.shape, rate, "cpu")
        np.testing.assert_array_equal(mask.numpy(), keep)


def test_transducer_joint_dropout_gradient_and_no_key():
    f = torch.randn(1, 3, 8, requires_grad=True)
    g = torch.randn(1, 2, 8)
    joint = ttr.TransducerJoint(dropout=0.5)
    assert torch.equal(joint(f, g), f[:, :, None] + g[:, None])
    h = joint(f, g, rng=prng.PRNGKey(3))
    h.sum().backward()
    kept = (h != 0).float()
    assert torch.equal(f.grad, (kept * 2.0).sum(2))


def test_packed_layouts_raise_as_in_jax():
    for cls, kw in ((jtr.TransducerJoint, dict(pack_output=True)),
                    (ttr.TransducerJoint, dict(pack_output=True)),
                    (jtr.TransducerLoss, dict(packed_input=True)),
                    (ttr.TransducerLoss, dict(packed_input=True))):
        with pytest.raises(NotImplementedError, match="packed"):
            cls(**kw)


# -------------------------------------------------------------- sparsity

def test_pattern_tables_are_jax_tables():
    for m, n in ((4, 2), (4, 1), (6, 3)):
        np.testing.assert_array_equal(tsp._patterns_1d(m, n),
                                      jsp._patterns_1d(m, n))
    np.testing.assert_array_equal(tsp._patterns_2d(4, 2),
                                  jsp._patterns_2d(4, 2))
    assert tsp._patterns_2d(4, 2).shape == (90, 4, 4)


MASK_SHAPES = [(32, 64), (8, 4, 24), (3, 3, 16, 12), (1, 48)]


@pytest.mark.parametrize("shape", MASK_SHAPES,
                         ids=["x".join(map(str, s)) for s in MASK_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_1d_and_greedy_masks_are_jax_bit_for_bit(shape, dtype):
    rng = np.random.RandomState(sum(shape))
    jw = jnp.asarray(rng.randn(*shape), dtype)
    tw = torch.tensor(_np(jw)).to(getattr(torch, dtype))
    patterns = ["m4n2_1d"]
    if len(shape) != 3 and shape[0] % 4 == 0 and (
            len(shape) == 2 or shape[2] % 4 == 0):
        patterns.append("m4n2_2d_greedy")
    for p in patterns:
        want = np.asarray(jsp.create_mask(jw, p))
        got = tsp.create_mask(tw, p)
        assert got.dtype == torch.bool and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=p)


@pytest.mark.parametrize("shape", [(64, 128), (3, 3, 32, 16)])
def test_2d_best_masks_equal_jax_but_on_near_ties(shape):
    """Equal to JAX's mask on every block but those whose two best of the
    90 scores are within fp32 rounding; each mask is doubly 2:4."""
    rng = np.random.RandomState(len(shape))
    w = rng.randn(*shape).astype(np.float32)
    # ties on purpose: blocks of equal magnitudes (the first block of
    # the 2-D weight; of each (h, w) tap's for the HWIO kernel)
    w[..., :4, :4] = 0.5
    want = np.asarray(jsp.create_mask(jnp.asarray(w), "m4n2_2d_best"))
    got = tsp.create_mask(torch.tensor(w), "m4n2_2d_best").numpy()
    w2d = torch.tensor(w)
    if w.ndim == 4:
        h, kw, i, o = shape
        w2d = w2d.permute(0, 1, 3, 2).reshape(h * kw * o, i)
        got2d = got.transpose(0, 1, 3, 2).reshape(h * kw * o, i)
        want2d = want.transpose(0, 1, 3, 2).reshape(h * kw * o, i)
    else:
        got2d, want2d = got, want
    rows, cols = w2d.shape
    differ = (got2d != want2d).reshape(rows // 4, 4, cols // 4, 4).any(
        axis=(1, 3))
    ties = tsp.near_tie_blocks(w2d).numpy()
    assert not (differ & ~ties).any()
    assert ties.sum() >= 1        # the equal-magnitude block at least
    blocks = got2d.reshape(rows // 4, 4, cols // 4, 4)
    assert (blocks.sum(axis=3) == 2).all() and (blocks.sum(axis=1) == 2).all()


def test_mask_calculators_raise_as_jax():
    for mod in (jsp, tsp):
        lib = jnp if mod is jsp else torch
        with pytest.raises(ValueError, match="multiple-of-4"):
            mod.mn_1d_best(lib.ones((4, 6)))
        with pytest.raises(ValueError, match="multiple-of-4"):
            mod.mn_2d_best(lib.ones((6, 8)))
        with pytest.raises(ValueError, match="unknown sparsity pattern"):
            mod.create_mask(lib.ones((4, 4)), "m8n4")
        with pytest.raises(ValueError, match="5-d"):
            mod.create_mask(lib.ones((1, 1, 1, 4, 4)))
    # greedy on a weight that fills no block is dense, as in JAX
    assert tsp.mn_2d_greedy(torch.ones(3, 8)).all()


def _tree(rng):
    return {"fc1": {"weight": rng.randn(16, 32).astype(np.float32),
                    "bias": rng.randn(32).astype(np.float32)},
            "conv": {"kernel": rng.randn(3, 3, 8, 4).astype(np.float32)},
            "norm": {"scale": rng.randn(8, 8).astype(np.float32)},
            "odd": rng.randn(4, 6).astype(np.float32),
            "blocks": [{"weight": rng.randn(8, 8).astype(np.float32)}]}


@pytest.mark.parametrize("pattern", ["m4n2_1d", "m4n2_2d_best"])
def test_asp_masks_and_lifecycle_match_jax(pattern):
    """The same leaves are eligible, the masks and the pruned, extracted
    and restored trees equal JAX's, and so does the sparsity."""
    tree = _tree(np.random.RandomState(9))
    jasp, tasp = jsp.ASP(pattern), tsp.ASP(pattern)
    jmasks = jasp.compute_sparse_masks(jax.tree.map(jnp.asarray, tree))
    tparams = jax.tree.map(torch.tensor, tree)
    tmasks = tasp.compute_sparse_masks(tparams)
    assert jax.tree.structure(tmasks) == jax.tree.structure(jmasks)
    for a, b in zip(jax.tree.leaves(tmasks), jax.tree.leaves(jmasks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not tmasks["odd"].logical_not().any()        # 6 % 4: dense
    assert not tmasks["fc1"]["bias"].logical_not().any()
    assert tasp.sparsity(tmasks) == pytest.approx(jasp.sparsity(jmasks))
    pruned = tasp.apply_masks(tparams, tmasks)
    jpruned = jasp.apply_masks(jax.tree.map(jnp.asarray, tree), jmasks)
    res = tasp.extract_pruned(tparams, tmasks)
    back = tasp.restore_dense(pruned, tmasks, res)
    for a, b, c, d in zip(jax.tree.leaves(pruned), jax.tree.leaves(jpruned),
                          jax.tree.leaves(back), jax.tree.leaves(tparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(c, d)


def test_wrapped_steps_keep_the_masks():
    """JAX's functional contract (``prune_trained_model``) and the
    in-place one over a PyTorch optimizer: after a step the pruned
    weights are still zero."""
    tree = _tree(np.random.RandomState(10))

    def jstep(state, grads, params):
        return jax.tree.map(lambda p, g: p - 0.1 * g, params, grads), state

    def tstep(state, grads, params):
        return _map2(lambda p, g: p - 0.1 * g, params, grads), state

    def _map2(fn, a, b):
        return jax.tree.map(fn, a, b)

    jp, jmasks, jwrapped = jsp.prune_trained_model(
        jax.tree.map(jnp.asarray, tree), jstep)
    tp, tmasks, twrapped = tsp.prune_trained_model(
        jax.tree.map(torch.tensor, tree), tstep)
    grads = jax.tree.map(lambda a: np.ones_like(a), tree)
    jnew, _ = jwrapped(0, jax.tree.map(jnp.asarray, grads), jp)
    tnew, _ = twrapped(0, jax.tree.map(torch.tensor, grads), tp)
    for a, b in zip(jax.tree.leaves(tnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # in place: an SGD step on the module's parameters, then the masks
    params = {k: torch.nn.Parameter(torch.tensor(v))
              for k, v in (("w", tree["fc1"]["weight"]),
                           ("bias", tree["fc1"]["bias"]))}
    asp = tsp.ASP()
    masks = asp.compute_sparse_masks(params)
    asp.apply_masks_(params, masks)
    opt = torch.optim.SGD(params.values(), lr=0.1)
    step = asp.wrap_optimizer_step(opt.step, masks, params=params)
    for p in params.values():
        p.grad = torch.ones_like(p)
    step()
    assert (params["w"][~masks["w"]] == 0).all()
    assert (params["w"][masks["w"]] != 0).all()
    assert asp.sparsity(masks) == pytest.approx(0.5 * 512 / (512 + 32))


def test_contrib_layers_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tgbn.BatchNorm2d_NHWC(4),
                 lambda: tbot.Bottleneck(4, 2, 8),
                 lambda: tfast.FastLayerNorm(8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_chip_check_of_the_library_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_library`` at CPU size: every module's GPU-vs-
    CPU check, timing and launch plumbing run on CPU tensors (the kernels'
    plain versions, so the launch counts are stubbed), the masked
    FusedAdam step included."""
    import chip_smoke
    import apex_tpu_torch.ops as ops

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "_events_ms",
                        lambda run, iters: (run(), 0.0)[1])
    monkeypatch.setattr(ops, "launch_counts", lambda: {
        "ln_fwd": 10, "ln_bwd": 10, "dropout": 4, "multi_tensor_adam": 1})
    for name, value in dict(
            LIB_NORM=(2, 64, 128), LIB_FFN=(128, 64, 256),
            LIB_MLP_SIZES=[48, 64, 32, 1], LIB_MLP_BATCH=64,
            LIB_BLOCKS=((8, 4, 16, 1), (16, 8, 32, 2)), LIB_BLOCK_BATCH=4,
            LIB_BLOCK_SIZE=8, LIB_RNN_IN=8, LIB_RNN_HIDDEN=32, LIB_RNN_SEQ=10,
            LIB_RNN_BATCH=4, LIB_RNNT=dict(b=3, t=20, u=6, v=5, h=16),
            LIB_SPARSE=(("fc1", 64, 128),)).items():
        monkeypatch.setattr(chip_smoke, name, value)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    out = chip_smoke.phase_library(torch.device("cpu"))
    assert {"FusedLayerNorm", "FastLayerNorm", "FusedRMSNorm",
            "MixedFusedLayerNorm", "FusedDenseGeluDense", "FusedDense",
            "MLP relu", "MLP sigmoid", "BatchNorm2d_NHWC", "LSTM", "mLSTM",
            "transducer joint + loss", "sparsity fc1 m4n2_1d",
            "sparsity fc1 m4n2_2d_best"} <= set(out)
    assert all(out[k]["err"] == 0 for k in out if "err" in out[k])
    assert any("masked FusedAdam step: pruned weights zero" in ln
               for ln in lines)
