"""The layer norm's backward (``ln_bwd`` + ``ln_bwd_fold``) and its plan,
on the CPU: the port's plain versions against the JAX package.

The same numpy inputs go through ``jax.vjp`` of the JAX entries with
``implementation="pallas"`` (the Pallas forward in interpret mode, the
backward in XLA) and through the port's autograd on CPU tensors, whose
backward is the plain version of the two kernels: the same roundings and
the column sums in the kernels' order (per-block partials, then the
fold), which the card's kernels match bit for bit (``chip_smoke.py``).

Tolerances: fp32 dx to ``FP32_TOL`` (1e-5 absolute and relative: two fp32
reductions taken in different orders); a bf16 dx to ``BF16_TOL`` (one
bf16 ulp at the output's magnitude: both round the same fp32 value, which
may fall on either side of a rounding boundary); fp32 dscale and dbias,
sums over every row, to ``SUM_TOL`` (rtol 1e-4, atol 1e-5), except that
with a bf16 x dscale also takes ``flip_atol``: the port's and JAX's fp32
statistics differ in their last bits, so the bf16 ``xhat_r`` of an
element that lies at a rounding boundary may round the other way, which
moves its column's sum by ``|dy| * ulp(xhat)``; the bound allows two such
flips in a column at the largest ``|dy|`` and ``|xhat|``.  bf16 dscale and
dbias, those sums rounded to bf16 at the end, to ``BF16_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_ln
from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.ops.common import launch_counts

torch.set_num_threads(1)  # the suite's parallel workers share the cores

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)
SUM_TOL = dict(rtol=1e-4, atol=1e-5)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
KERNELS = (port_ln.KERNEL, port_ln.KERNEL_BWD, port_ln.KERNEL_FOLD)


def flip_atol(x, dy):
    """Two bf16 roundings of ``xhat`` flipped in a column (see above)."""
    xf = x.astype(np.float64)
    xhat = (xf - xf.mean(-1, keepdims=True)) / xf.std(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(xhat).max())) - 7)
    return 2.0 * np.abs(dy).max() * ulp


def _inputs(rows, hidden, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, hidden) * 3.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(hidden)).astype(np.float32)
    b = (0.1 * rng.randn(hidden)).astype(np.float32)
    dy = rng.randn(rows, hidden).astype(np.float32)
    return x, w, b, dy


def _jax_grads(x, w, b, dy, rms, x_dt, p_dt):
    hidden = x.shape[-1]
    args = [jnp.asarray(x, x_dt), jnp.asarray(w, p_dt)]
    if rms:
        f = lambda x, w: jax_ln.fused_rms_norm_affine(
            x, w, hidden, implementation="pallas")
    else:
        args.append(jnp.asarray(b, p_dt))
        f = lambda x, w, b: jax_ln.fused_layer_norm_affine(
            x, w, b, hidden, implementation="pallas")
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(dy, x_dt))]


def _port_grads(x, w, b, dy, rms, x_dt, p_dt):
    hidden = x.shape[-1]
    tx = torch.from_numpy(x).to(x_dt).requires_grad_()
    tw = torch.from_numpy(w).to(p_dt).requires_grad_()
    leaves = [tx, tw]
    if rms:
        y = port_ln.fused_rms_norm_affine(tx, tw, hidden)
    else:
        tb = torch.from_numpy(b).to(p_dt).requires_grad_()
        leaves.append(tb)
        y = port_ln.fused_layer_norm_affine(tx, tw, tb, hidden)
    y.backward(torch.from_numpy(dy).to(x_dt))
    assert tx.grad.dtype == x_dt
    assert all(t.grad.dtype == p_dt for t in leaves[1:])
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("hidden", [1024, 72, 1000])
@pytest.mark.parametrize("p_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("rms", [False, True], ids=["layernorm", "rmsnorm"])
def test_grads_match_jax_vjp(rms, x_dtype, p_dtype, hidden):
    """dx, dscale (and dbias) of the affine entries against ``jax.vjp``:
    layer norm and RMSNorm, bf16 and fp32 x and parameters (fp32 x with
    bf16 parameters is the final norm's ``x.float()`` without a keep-norm-
    fp32 policy), the flagship's hidden and two ragged ones."""
    x, w, b, dy = _inputs(5, hidden, seed=hidden + 2 * rms)
    args = (x, w, b, dy, rms, DTYPES[x_dtype][0], DTYPES[p_dtype][0])
    want = _jax_grads(*args)
    got = _port_grads(x, w, b, dy, rms, DTYPES[x_dtype][1],
                      DTYPES[p_dtype][1])
    assert len(got) == len(want) == (2 if rms else 3)
    np.testing.assert_allclose(
        got[0], want[0], err_msg="dx",
        **(FP32_TOL if x_dtype == "fp32" else BF16_TOL))
    for name, g, w_ in zip(("dscale", "dbias"), got[1:], want[1:]):
        tol = dict(SUM_TOL if p_dtype == "fp32" else BF16_TOL)
        if name == "dscale" and x_dtype == "bf16":
            tol["atol"] = max(tol["atol"], flip_atol(x, dy))
        np.testing.assert_allclose(g, w_, err_msg=name, **tol)


@pytest.mark.parametrize("rows", [13, 1100])
def test_rows_off_the_block_split_match_jax(rows):
    """Row counts that leave the last backward block short (the plan's
    rows_per_block does not divide them), bf16 x with fp32 parameters as
    the O5 norms run."""
    plan = port_ln.layer_norm_plan(rows, 64, torch.bfloat16, torch.float32)
    assert rows % plan.rows_per_block != 0
    x, w, b, dy = _inputs(rows, 64, seed=rows)
    want = _jax_grads(x, w, b, dy, False, jnp.bfloat16, jnp.float32)
    got = _port_grads(x, w, b, dy, False, torch.bfloat16, torch.float32)
    np.testing.assert_allclose(got[0], want[0], err_msg="dx", **BF16_TOL)
    np.testing.assert_allclose(got[1], want[1], err_msg="dscale",
                               rtol=SUM_TOL["rtol"], atol=flip_atol(x, dy))
    np.testing.assert_allclose(got[2], want[2], err_msg="dbias", **SUM_TOL)


@pytest.mark.parametrize("hidden", [72, 1000])
@pytest.mark.parametrize("entry", ["fused_layer_norm", "fused_rms_norm",
                                   "mixed_dtype_fused_layer_norm_affine"])
def test_entries_without_affine_grads_match_jax(entry, hidden):
    """The non-affine entries (the unit-scale path, whose parameter
    gradients are not asked for) and the mixed-dtype entry (bf16 x, fp32
    parameters, output in the weight's dtype) at ragged hiddens."""
    x, w, b, dy = _inputs(6, hidden, seed=len(entry) + hidden)
    mixed = entry.startswith("mixed")
    jfn, pfn = getattr(jax_ln, entry), getattr(port_ln, entry)
    jx = jnp.asarray(x, jnp.bfloat16 if mixed else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if mixed else torch.float32)
    if mixed:
        jargs = (jx, jnp.asarray(w), jnp.asarray(b))
        targs = [tx, torch.from_numpy(w), torch.from_numpy(b)]
        jcall = lambda *a: jfn(*a, hidden, implementation="pallas")
        pcall = lambda *a: pfn(*a, hidden)
    else:
        jargs, targs = (jx,), [tx]
        jcall = lambda a: jfn(a, hidden, implementation="pallas")
        pcall = lambda a: pfn(a, hidden)
    _, vjp = jax.vjp(jcall, *jargs)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy))]
    targs = [t.clone().requires_grad_() for t in targs]
    pcall(*targs).backward(torch.from_numpy(dy))
    got = [t.grad.float().numpy() for t in targs]
    np.testing.assert_allclose(got[0], want[0], err_msg="dx",
                               **(BF16_TOL if mixed else FP32_TOL))
    if mixed:
        np.testing.assert_allclose(got[1], want[1], err_msg="dweight",
                                   rtol=SUM_TOL["rtol"],
                                   atol=flip_atol(x, dy))
        np.testing.assert_allclose(got[2], want[2], err_msg="dbias",
                                   **SUM_TOL)


def test_zero_rows():
    """No rows: dx is empty and the parameter gradients are zeros."""
    x = torch.zeros((0, 48), dtype=torch.bfloat16)
    w = torch.ones(48, dtype=torch.float32)
    dx, dscale, dbias = port_ln.layer_norm_bwd(
        x, x, w, torch.float32, torch.zeros(0), torch.zeros(0), False)
    assert dx.shape == (0, 48) and dx.dtype == torch.bfloat16
    assert torch.equal(dscale, torch.zeros(48))
    assert torch.equal(dbias, torch.zeros(48))
    assert port_ln.layer_norm_plan(0, 48, torch.bfloat16,
                                   torch.float32).blocks == 0


def _kernel_order(terms, warps, rows_per_block, blocks, runs):
    """The kernels' sums of ``terms (rows, hidden)`` written out as loops
    in numpy fp32: a warp's rows in row order, a block's warps in warp
    order, the fold's runs of blocks in block order, the runs in order."""
    rows, hidden = terms.shape
    partials = np.zeros((blocks, hidden), np.float32)
    for blk in range(blocks):
        for w in range(warps):
            acc = np.zeros(hidden, np.float32)
            for row in range(blk * rows_per_block + w,
                             min(rows, (blk + 1) * rows_per_block), warps):
                acc = acc + terms[row]
            partials[blk] = partials[blk] + acc
    run = -(-blocks // runs)
    total = np.zeros(hidden, np.float32)
    for r in range(runs):
        acc = np.zeros(hidden, np.float32)
        for blk in range(r * run, min(blocks, (r + 1) * run)):
            acc = acc + partials[blk]
        total = total + acc
    return partials, total


@pytest.mark.parametrize("rows, hidden", [(37, 5), (300, 3), (2000, 2)])
def test_two_stage_sum_is_the_kernels_order(rows, hidden):
    """The plain version's column sums add in the kernels' order (the
    same values as the loops above) and agree with the one-stage sum to
    fp32 rounding."""
    rng = np.random.RandomState(rows)
    terms = (rng.randn(rows, hidden) * 10.0).astype(np.float32)
    warps, rpb, blocks = port_ln._bwd_split(rows, hidden)
    partials, total = _kernel_order(terms, warps, rpb, blocks,
                                    port_ln.FOLD_RUNS)
    t = torch.from_numpy(terms)[None]
    got_partials = port_ln._partials_plain(t)[0]
    got = port_ln._column_sums_plain(t)[0]
    assert got_partials.shape == (blocks, hidden)
    assert np.array_equal(got_partials.numpy(), partials)
    assert np.array_equal(got.numpy(), total)
    one_stage = terms.astype(np.float64).sum(0)
    np.testing.assert_allclose(got.numpy(), one_stage, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("rows, hidden, x_dtype", [
    (4, 1024, torch.bfloat16), (8192, 1024, torch.bfloat16),
    (2304, 1024, torch.float32), (1, 72, torch.bfloat16),
    (301, 1000, torch.float32), (9, 3000, torch.float16),
    (5, 4100, torch.float16), (3, port_ln.MAX_HIDDEN, torch.bfloat16)])
def test_plan_from_shapes(rows, hidden, x_dtype):
    """The plan from shapes alone: the 16-byte instances where hidden is a
    multiple of 16 bytes of x, the forward grid capped, the backward's
    blocks a whole number of warps' rows covering every row once, within
    the block cap and the shared memory limit (8 bytes a column a warp)."""
    plan = port_ln.layer_norm_plan(rows, hidden, x_dtype, torch.float32)
    assert plan.vec == (hidden * x_dtype.itemsize % 16 == 0)
    assert plan.fwd_grid == min(-(-rows // port_ln.FWD_WARPS),
                                port_ln.FWD_MAX_BLOCKS)
    assert 1 <= plan.warps <= port_ln.BWD_WARPS
    assert plan.rows_per_block % plan.warps == 0
    assert (plan.blocks - 1) * plan.rows_per_block < rows
    assert plan.blocks * plan.rows_per_block >= rows
    assert plan.blocks <= port_ln.BWD_MAX_BLOCKS
    assert plan.warps * 8 * hidden <= port_ln.SMEM_LIMIT
    assert plan.partials == 2 * plan.blocks * hidden


@pytest.mark.parametrize("hidden, x_dtype, w_dtype", [
    (0, torch.bfloat16, torch.float32),
    (port_ln.MAX_HIDDEN + 1, torch.bfloat16, torch.float32),
    (64, torch.float64, torch.float32), (64, torch.bfloat16, torch.int8)])
def test_plan_rejects_what_the_kernels_do_not_take(hidden, x_dtype,
                                                   w_dtype):
    with pytest.raises(ValueError):
        port_ln.layer_norm_plan(4, hidden, x_dtype, w_dtype)


def test_cpu_path_launches_no_kernel():
    """Forward and backward through autograd on CPU tensors: the plain
    versions, no count moves."""
    before = {k: launch_counts().get(k, 0) for k in KERNELS}
    x, w, b, dy = _inputs(9, 40, seed=3)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    port_ln.fused_layer_norm_affine(tx, tw, tb, 40).backward(
        torch.from_numpy(dy))
    port_ln.fused_rms_norm(tx, 40).sum().backward()
    assert {k: launch_counts().get(k, 0) for k in KERNELS} == before


def test_params_false_skips_the_column_sums():
    x, w, b, dy = _inputs(7, 24, seed=5)
    t = [torch.from_numpy(a) for a in (dy, x, w)]
    _, mean, invvar = port_ln.layer_norm_fwd(t[1], t[2], None, 1e-5, False)
    full = port_ln.layer_norm_bwd(*t, torch.float32, mean, invvar, False)
    dx, ds, db = port_ln.layer_norm_bwd(*t, torch.float32, mean, invvar,
                                        False, params=False)
    assert ds is None and db is None and torch.equal(dx, full[0])


def test_backward_rejects_other_devices():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_ln.layer_norm_bwd(x, x, torch.empty(8, device="meta"), None,
                               torch.empty(2, device="meta"),
                               torch.empty(2, device="meta"), True)


@pytest.mark.parametrize("params", [True, False])
def test_wrappers_count_their_launches(monkeypatch, params):
    """The forward counts ``ln_fwd`` once a call, the backward ``ln_bwd``
    once and ``ln_bwd_fold`` once when the parameter gradients are asked
    for; each C entry gets as many arguments as its ctypes types, the
    plan's grid and split among them (run on CPU tensors with the C
    entries replaced, so nothing is launched)."""
    from apex_tpu_torch.ops.common import reset_launch_counts

    calls = []

    def entry(symbol):
        return None, lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(port_ln, "_entry", entry)
    monkeypatch.setattr(port_ln, "stream_of", lambda t: None)
    rows, hidden = 300, 1024
    x = torch.zeros((rows, hidden), dtype=torch.bfloat16)
    w = torch.zeros(hidden)
    stats = torch.zeros(rows)
    reset_launch_counts()
    port_ln._ln_fwd_cuda(x, w, w, 1e-5, False)
    port_ln._ln_bwd_cuda(x, x, w, torch.float32, stats, stats, False, params)
    plan = port_ln.layer_norm_plan(rows, hidden, x.dtype, w.dtype)
    want = ["ln_fwd", "ln_bwd"] + (["ln_bwd_fold"] if params else [])
    assert [c[0] for c in calls] == want
    for symbol, args in calls:
        assert len(args) == len(port_ln.ARGTYPES[symbol])
    fwd, bwd = calls[0][1], calls[1][1]
    assert fwd[-3:-1] == (port_ln.FWD_WARPS, plan.fwd_grid)
    assert bwd[-4:-1] == (plan.warps, plan.rows_per_block, plan.blocks)
    assert (bwd[6] is None) == (not params)
    assert {k: v for k, v in launch_counts().items() if v} == {
        k: 1 for k in want}


def _phase_two(monkeypatch):
    """``chip_smoke.layer_norm_kernels`` on the CPU at small rows: the
    timers stubbed (they capture CUDA graphs) and the fold's C entry
    replaced by its plain version."""
    import chip_smoke as cs
    from apex_tpu_torch.ops import common

    def fold(partials, dscale, dbias, blocks, hidden, stream):
        sums = port_ln._fold_plain(partials.view(2, blocks, hidden))
        dscale.copy_(sums[0])
        dbias.copy_(sums[1])

    monkeypatch.setattr(cs, "time_ms", lambda fn, iters=50: (fn(), (1.0,
                                                                     1.0))[1])
    monkeypatch.setattr(cs, "profiled_ms", lambda fn, iters=10: (fn(),
                                                                 1.0)[1])
    monkeypatch.setattr(port_ln, "_fold_cuda", fold)
    monkeypatch.setattr(common, "stream_of", lambda t: None)
    monkeypatch.setattr(cs, "LN_ROWS", (4, 40, 70))
    monkeypatch.setattr(cs, "LN_BWD_ROWS", (40, 70))
    monkeypatch.setattr(cs, "LN_PROBES", cs.LN_PROBES[:2])
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dtype)

    return cs, lambda: cs.layer_norm_kernels(randn, torch.device("cpu"))


def test_phase_two_holds_the_layer_norm(monkeypatch):
    """Every case runs, and each kernel's first record (the one the
    result line carries) is at the main path's shape: the forward at 4
    rows, the backward and the fold at the training rows, bf16 layer
    norm."""
    cs, run = _phase_two(monkeypatch)
    records = run()
    assert len(records["ln_fwd"]) == 3 * len(cs.LN_CASES)
    assert len(records["ln_bwd"]) == 2 * len(cs.LN_CASES)
    assert len(records["ln_bwd_fold"]) == 2
    assert records["ln_fwd"][0]["shape"].startswith("rows=4 ")
    assert records["ln_bwd"][0]["shape"] == \
        "rows=70 hidden=1024 layer norm bf16"
    blocks = port_ln.layer_norm_plan(70, 1024, torch.bfloat16,
                                     torch.float32).blocks
    assert records["ln_bwd_fold"][0]["shape"].startswith(f"blocks={blocks} ")


def test_phase_two_rejects_column_sums_off_the_plain_order(monkeypatch):
    """A backward whose dscale differs from the plain version's in the
    last bit fails the phase, though it would pass a tolerance."""
    cs, run = _phase_two(monkeypatch)
    real = port_ln.layer_norm_bwd

    def off(*args, **kw):
        dx, dscale, dbias = real(*args, **kw)
        return dx, torch.nextafter(dscale, torch.full_like(dscale, 1e9)), \
            dbias

    monkeypatch.setattr(port_ln, "layer_norm_bwd", off)
    with pytest.raises(SystemExit):
        run()
