"""The port's multi-tensor operations (``apex_tpu_torch.multi_tensor_apply``,
``ops/multi_tensor.py``) against the JAX package, and each kernel's plain
version against the per-tensor plain math.

On the CPU the wrappers run their plain versions, so these tests hold the
arithmetic that ``chip_smoke.py`` then holds the CUDA kernels to.  Inputs
are numpy arrays from a seed, over lists with a zero-size tensor, odd
lengths and mixed dtypes (fp32, bf16, fp16).

Tolerances: scale and axpby are one fp32 multiply (and add) rounded to the
output dtype, so they equal JAX's bits; the norms add in another order
than XLA's, so they agree to 1e-6 relative; Adam and LAMB's plain
versions agree with JAX's elementwise formula to 1e-6 relative and 1e-7
absolute (XLA may fuse ``a*b + c*d``), one bf16 ulp where stored in bf16.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import multi_tensor_apply as jmta
from apex_tpu.amp import scaler as jscaler
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu_torch import convert
from apex_tpu_torch import multi_tensor_apply as mta
from apex_tpu_torch.amp import scaler
from apex_tpu_torch.ops import common
from apex_tpu_torch.ops import multi_tensor as mt

ROOT = Path(__file__).resolve().parent.parent
FP32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=8e-3, atol=1e-6)
#: shapes of the edge list: a zero-size tensor and odd lengths
SHAPES = ((0,), (1,), (7,), (1001,), (33, 31), (5, 3))
DTYPES = (np.float32, jnp.bfloat16, np.float32, np.float16, jnp.bfloat16,
          np.float32)


def _arrays(seed, scale=1.0, inf_at=None):
    rng = np.random.RandomState(seed)
    out = [(scale * rng.randn(*s)).astype(np.float32).astype(d)
           for s, d in zip(SHAPES, DTYPES)]
    if inf_at is not None:
        out[inf_at].reshape(-1)[-1] = np.inf
    return out


def _tensors(arrays):
    return [convert._tensor(a) for a in arrays]


def _equal(got, want):
    for a, b in zip(got, want):
        assert convert._array(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(convert._array(a), np.asarray(b))


@pytest.mark.parametrize("inf_at", [None, 1, 4])
@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_scale_equals_jax(inf_at, out_dtype):
    xs = _arrays(0, 3.0, inf_at)
    got, over = mta.multi_tensor_scale(
        _tensors(xs), 0.37, None if out_dtype is None else torch.float32)
    want, jover = jmta.multi_tensor_scale(
        [jnp.asarray(x) for x in xs], 0.37,
        None if out_dtype is None else jnp.float32)
    assert bool(over) == bool(jover) == (inf_at is not None)
    _equal(got, want)


@pytest.mark.parametrize("inf_at", [None, 2])
def test_axpby_equals_jax(inf_at):
    xs, ys = _arrays(1, inf_at=inf_at), _arrays(2)
    got, over = mta.multi_tensor_axpby(0.5, _tensors(xs), -1.25, _tensors(ys))
    want, jover = jmta.multi_tensor_axpby(0.5, [jnp.asarray(x) for x in xs],
                                          -1.25, [jnp.asarray(y) for y in ys])
    assert bool(over) == bool(jover) == (inf_at is not None)
    _equal(got, want)


def test_l2norms_and_all_finite_equal_jax():
    xs = _arrays(3, 2.0)
    total, per = mta.multi_tensor_l2norm(_tensors(xs), per_tensor=True)
    jtotal, jper = jmta.multi_tensor_l2norm([jnp.asarray(x) for x in xs],
                                            per_tensor=True)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    np.testing.assert_allclose([float(p) for p in per],
                               [float(p) for p in jper], rtol=1e-6)
    assert float(mta.global_l2norm(_tensors(xs))) == float(total)
    for inf_at in (None, 1, 5):
        xs = _arrays(4, inf_at=inf_at)
        assert bool(scaler.all_finite(_tensors(xs))) == bool(
            jscaler.all_finite([jnp.asarray(x) for x in xs])) == (
            inf_at is None)


def test_applier_calls_the_op():
    seen = []
    for cls in (mta.MultiTensorApply, mta.multi_tensor_applier,
                jmta.multi_tensor_applier):
        app = cls(1024)
        assert app.available and app.chunk_size == 1024
        seen.append(app(lambda lists, a: (len(lists), a), None, [[1], [2]], 7))
    assert seen == [(2, 7)] * 3


# ----------------------------------------- plain versions, tensor by tensor
def test_scale_plain_is_the_per_tensor_math():
    xs = _tensors(_arrays(5, 4.0))
    out = [torch.empty_like(x) for x in xs]
    flag = mt.scale(xs, 0.37, out=out)
    assert bool(flag)
    for x, o in zip(xs, out):
        assert torch.equal(o, (x.float() * 0.37).to(x.dtype))
    ys = _tensors(_arrays(6))
    mt.scale(xs, 0.5, ys=ys, b=2.0, out=out)
    for x, y, o in zip(xs, ys, out):
        assert torch.equal(o, (0.5 * x.float() + 2.0 * y.float()).to(x.dtype))
    inv = torch.tensor(0.25)
    assert torch.equal(mt._unscaled(xs[1], inv),
                       (xs[1].float() * 0.25).to(xs[1].dtype).float())


def test_l2norm_plain_is_the_per_tensor_math():
    xs = _tensors(_arrays(7))
    norms = mt.l2norm(xs, per_tensor=True)
    want = [torch.linalg.vector_norm(x.double()) for x in xs]
    np.testing.assert_allclose(norms.per_tensor.numpy(),
                               [float(w) for w in want], rtol=1e-6)
    np.testing.assert_allclose(
        float(norms.total),
        float(torch.linalg.vector_norm(torch.stack(want))), rtol=1e-6)
    np.testing.assert_allclose(norms.sq.numpy(),
                               [float(w) ** 2 for w in want], rtol=2e-6)
    inv = torch.tensor(0.5)
    half = mt.l2norm(xs, inv_scale=inv)
    np.testing.assert_allclose(float(half.total), float(norms.total) / 2,
                               rtol=1e-2)


def _step_case(seed, master, v_dtype):
    """Parameters, gradients and a mid-training Adam state over the edge
    list (no fp16 parameters: the step kernels keep fp32/bf16 state)."""
    rng = np.random.RandomState(seed)
    dts = [np.float32 if d == np.float16 else d for d in DTYPES]
    p = [(0.1 * rng.randn(*s)).astype(np.float32).astype(d)
         for s, d in zip(SHAPES, dts)]
    g = [(rng.randn(*s)).astype(np.float32).astype(d)
         for s, d in zip(SHAPES, dts)]
    m = [(1e-2 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    v = [(1e-2 * rng.randn(*s) ** 2).astype(np.float32).astype(v_dtype)
         for s in SHAPES]
    return p, g, m, v


def _jax_state(opt, p, m, v, step, master):
    tree = lambda xs: {str(i): jnp.asarray(x) for i, x in enumerate(xs)}
    state = {"step": jnp.int32(step), "exp_avg": tree(m), "exp_avg_sq":
             tree(v)}
    if master:
        state["master"] = tree([np.asarray(x).astype(np.float32) for x in p])
    return state


@pytest.mark.parametrize("kernel", ["adam", "lamb"])
@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("v_dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("clip", [False, True])
def test_step_plain_versions_equal_jax(kernel, master, v_dtype, clip):
    """``mt.adam`` / ``mt.lamb`` (their plain versions here) against JAX's
    FusedAdam / FusedLAMB from the same mid-training state (step 6 -> 7),
    with the clip factor JAX computes."""
    p, g, m, v = _step_case(8, master, v_dtype)
    names = [str(i) for i in range(len(p))]
    if kernel == "adam":
        jopt = JaxFusedAdam(lr=1e-2, weight_decay=0.01, master_weights=master,
                            max_grad_norm=1.0 if clip else None,
                            exp_avg_sq_dtype=v_dtype)
    else:
        jopt = JaxFusedLAMB(lr=1e-2, weight_decay=0.01, master_weights=master,
                            max_grad_norm=1.0 if clip else 0.0,
                            exp_avg_sq_dtype=v_dtype)
    jstate = _jax_state(jopt, p, m, v, 6, master)
    jp = {n: jnp.asarray(x) for n, x in zip(names, p)}
    jg = {n: jnp.asarray(x) for n, x in zip(names, g)}
    new_p, new_s = jopt.step(jstate, jg, jp)
    tp, tg = _tensors(p), _tensors(g)
    tm, tv = _tensors(m), _tensors(v)
    masters = [t.float() for t in tp] if master else None
    rows = mt.step_rows(tp, masters, tm, tv)
    stepf = torch.tensor(7.0)
    bc1, bc2 = 1.0 - torch.pow(0.9, stepf), 1.0 - torch.pow(0.999, stepf)
    clipf = None
    if clip:
        gn = mt.l2norm(tg).total
        clipf = torch.where(gn > 1.0, gn.new_full((), 1.0) / gn,
                            torch.ones_like(gn))
    if kernel == "adam":
        mt.adam(tg, rows, lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.01, adam_w_mode=True, bc1=bc1, bc2=bc2,
                clip=clipf)
    else:
        mt.lamb(tg, rows, lr=1e-2, beta1=0.9, beta2=0.999,
                beta3=float(np.float32(1.0) - np.float32(0.9)), eps=1e-6,
                weight_decay=0.01, adam_w_mode=True, use_trust=True,
                bc1=bc1, bc2=bc2, clip=clipf)
    close = lambda t, w: np.testing.assert_allclose(
        t.float().numpy(), np.asarray(w).astype(np.float32),
        **(FP32_TOL if t.dtype == torch.float32 else BF16_TOL))
    for i, n in enumerate(names):
        close(tp[i], new_p[n])
        close(tm[i], new_s["exp_avg"][n])
        close(tv[i], new_s["exp_avg_sq"][n])
        if master:
            close(masters[i], new_s["master"][n])


def test_a_false_flag_writes_nothing():
    p, g, m, v = _step_case(9, True, np.float32)
    tp, tg, tm, tv = (_tensors(x) for x in (p, g, m, v))
    masters = [t.float() for t in tp]
    before = [t.clone() for t in tp + tm + tv + masters]
    rows = mt.step_rows(tp, masters, tm, tv)
    flag = torch.tensor(False)
    mt.adam(tg, rows, lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
            weight_decay=0.0, adam_w_mode=True, finite=flag)
    mt.lamb(tg, rows, lr=1e-2, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
            weight_decay=0.01, adam_w_mode=True, use_trust=True, finite=flag)
    for a, b in zip(tp + tm + tv + masters, before):
        assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="tensors on"):
        mt.scale([torch.ones(2), torch.ones(2, device="meta")])
    p = [torch.ones(3)]
    with pytest.raises(ValueError, match="exp_avg_sq dtype"):
        mt.step_rows(p, None, [torch.zeros(3)],
                     [torch.zeros(3, dtype=torch.float16)])
    rows = mt.step_rows(p, None, [torch.zeros(3)], [torch.zeros(3)])
    with pytest.raises(ValueError, match="not contiguous"):
        rows.fill_grads("k", [torch.ones(6)[::2]])
    with pytest.raises(ValueError, match="elements"):
        rows.fill_grads("k", [torch.ones(4)])


# ------------------------------------------------------ the launch plumbing
def _fake_entry(monkeypatch):
    """A stand-in for each C entry that records its arguments and reports
    success, so the launchers run on CPU tensors (nothing is launched)."""
    calls = []

    def entry(symbol):
        return None, lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(mt, "_entry", entry)
    monkeypatch.setattr(mt, "stream_of", lambda t: None)
    return calls


def test_launchers_count_and_pass_their_arguments(monkeypatch):
    """Each launcher calls its C entry once with as many arguments as its
    ctypes types and counts one launch under its kernel's name; the rows
    carry each tensor's pointers, sizes and dtype codes."""
    calls = _fake_entry(monkeypatch)
    common.reset_launch_counts()
    dev = torch.device("cpu")
    xs = [torch.ones(5), torch.ones(7, dtype=torch.bfloat16),
          torch.ones(0)]
    flag = torch.ones((), dtype=torch.bool)
    mt._scale_cuda(mt.KERNEL_SCALE, dev, xs, 2.0, None, 0.0, xs, flag)
    mt._scale_cuda(mt.KERNEL_AXPBY, dev, xs, 2.0, xs, 1.0, xs, flag)
    mt._l2norm_cuda(dev, xs, None, True, flag)
    p = [torch.ones(5), torch.ones(7, dtype=torch.bfloat16)]
    rows = mt.step_rows(p, [q.float() for q in p],
                        [torch.zeros(5), torch.zeros(7)],
                        [torch.zeros(5), torch.zeros(7)])
    rows.fill_grads(mt.KERNEL_ADAM, [torch.ones(5),
                                     torch.ones(7, dtype=torch.bfloat16)])
    hyper = mt._hyper(0.9, 0.999, 0.1, 1e-8, 1e-3, 0.0, True)
    mt._adam_cuda(dev, p, rows, hyper, None, None, None, None, flag)
    mt._lamb_cuda(dev, p, rows, hyper, True, None, None, None, None, flag)
    assert [c[0] for c in calls] == [mt.KERNEL_SCALE, mt.KERNEL_SCALE,
                                     mt.KERNEL_L2NORM, mt.KERNEL_ADAM,
                                     mt.KERNEL_LAMB]
    for symbol, args in calls:
        assert len(args) == len(mt.ARGTYPES[symbol]), symbol
    assert {k: v for k, v in common.launch_counts().items() if v} == {
        mt.KERNEL_SCALE: 1, mt.KERNEL_AXPBY: 1, mt.KERNEL_L2NORM: 1,
        mt.KERNEL_ADAM: 1, mt.KERNEL_LAMB: 1}
    assert rows.codes.tolist() == [[0, 0, 0], [1, 1, 0]]
    assert rows.sizes.tolist() == [5, 7]
    assert rows.ptrs[1, 1] == p[1].data_ptr()
    # the scale launch's mode and its rows: x, y (none), out
    ptrs = ctypes.cast(calls[0][1][0], ctypes.POINTER(ctypes.c_longlong))
    assert calls[0][1][4] == 1 and ptrs[0] == xs[0].data_ptr()


def test_source_constants_match_the_wrappers():
    src = (ROOT / "apex_tpu_torch" / "csrc" / "multi_tensor.cu").read_text()
    assert re.search(rf"kChunk = {mt.CHUNK};", src)
    assert re.search(rf"kVec = {mt.VEC};", src)
    assert "multi_tensor" in common.KERNEL_SOURCES
    # no float atomics: the norms are the same bits on every run
    assert not re.search(r"atomic\w*\s*\(", src)
    assert "__fmul_rn" in src and "__fdiv_rn" in src and "__fsqrt_rn" in src
