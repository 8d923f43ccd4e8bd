"""The port's amp cast decorators and cast lists against the JAX
package's (``apex_tpu.amp.functional``, ``apex_tpu.amp.lists``).

The same numpy inputs go through a JAX function decorated by JAX's
decorator and a torch function decorated by the port's: each side must
see the same dtypes and compute the same values (exact, the operations
being casts, or fp32 sums to 1e-6).  The lists must classify every JAX
entry the same, mapped onto ``torch`` / ``torch.nn.functional`` as the
module says.  ``patch()`` mutates the real torch namespaces, so every
test that calls it restores them in a ``finally``: nothing may leak to
another test of the same worker.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu.amp import functional as jfun
from apex_tpu.amp import lists as jlists
from apex_tpu_torch import amp
from apex_tpu_torch.amp import functional as tfun
from apex_tpu_torch.amp import lists as tlists

JAX_DTYPE = {jnp.float16: torch.float16, jnp.bfloat16: torch.bfloat16,
             jnp.float32: torch.float32}


@pytest.fixture
def low_precision():
    """Restore both packages' process-global low-precision dtype."""
    jprev, tprev = jfun._LOW_PRECISION["dtype"], tfun._LOW_PRECISION["dtype"]
    try:
        yield
    finally:
        jfun.set_low_precision_dtype(jprev)
        tfun.set_low_precision_dtype(tprev)


def _probe(record):
    """A function that records the dtypes of its (nested) arguments."""
    def fn(x, pair, scale=None, n=3):
        record.append((x.dtype, pair[0].dtype, pair[1].dtype,
                       None if scale is None else scale.dtype, n))
        return x
    return fn


@pytest.mark.parametrize("deco", ["half_function", "bfloat16_function",
                                  "float_function"])
@pytest.mark.parametrize("low", [jnp.float16, jnp.bfloat16])
def test_decorators_cast_nested_floats_as_jax(deco, low, low_precision):
    rng = np.random.RandomState(0)
    x = rng.randn(3).astype(np.float32)
    a = rng.randn(2).astype(np.float16)
    ids = np.arange(4, dtype=np.int32)
    jfun.set_low_precision_dtype(low)
    tfun.set_low_precision_dtype(JAX_DTYPE[low])
    jrec, trec = [], []
    getattr(jfun, deco)(_probe(jrec))(
        jnp.asarray(x), (jnp.asarray(a), jnp.asarray(ids)),
        scale=jnp.asarray(a))
    getattr(tfun, deco)(_probe(trec))(
        torch.from_numpy(x), [torch.from_numpy(a), torch.from_numpy(ids)],
        scale=torch.from_numpy(a))
    (jx, ja, ji, js, jn), (tx, ta, ti, ts, tn) = jrec[0], trec[0]
    assert (JAX_DTYPE[jx.type], JAX_DTYPE[ja.type], JAX_DTYPE[js.type]) \
        == (tx, ta, ts)
    assert ti == torch.int32 and ji == jnp.int32 and tn == jn == 3


def test_half_function_follows_the_global_dtype(low_precision):
    """One wrapper, its dtype read at each call: O1's fp16, O4's bf16,
    and bf16 before any is set, as in JAX."""
    tfun.set_low_precision_dtype(torch.bfloat16)
    f = amp.half_function(lambda x: x)
    x = torch.ones(2)
    assert f(x).dtype == torch.bfloat16
    amp.set_low_precision_dtype(torch.float16)
    assert f(x).dtype == torch.float16


def test_promote_function_picks_the_widest_as_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(4).astype(np.float16), rng.randn(4).astype(np.float32)
    jout = jfun.promote_function(jnp.add)(jnp.asarray(a), jnp.asarray(b))
    tout = tfun.promote_function(torch.add)(torch.from_numpy(a),
                                            torch.from_numpy(b))
    assert tout.dtype == JAX_DTYPE[jout.dtype.type] == torch.float32
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    # bf16 with fp16 promotes to fp32 in both packages
    jm = jfun.promote_function(jnp.add)(jnp.ones(2, jnp.bfloat16),
                                        jnp.ones(2, jnp.float16))
    tm = tfun.promote_function(torch.add)(torch.ones(2, dtype=torch.bfloat16),
                                          torch.ones(2, dtype=torch.float16))
    assert tm.dtype == JAX_DTYPE[jm.dtype.type]


def test_numpy_arguments_become_tensors_of_the_target_dtype():
    """JAX turns a floating numpy argument into an array of the target
    dtype; the port into a tensor of it, integers left alone."""
    x = np.linspace(-1, 1, 5).astype(np.float32)
    got = tfun.float_function(lambda t, i: (t, i))(x.astype(np.float16),
                                                   np.arange(3))
    want = jfun.float_function(lambda t, i: t)(x.astype(np.float16),
                                               np.arange(3))
    assert isinstance(got[0], torch.Tensor) and got[0].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert isinstance(got[1], np.ndarray)


def test_register_functions_rebind_a_module_attribute():
    import types

    ns = types.SimpleNamespace(mm=torch.matmul, s=torch.sum, c=torch.add)
    amp.register_half_function(ns, "mm")
    amp.register_float_function(ns, "s")
    amp.register_promote_function(ns, "c")
    x = torch.randn(2, 2, dtype=torch.float16)
    assert ns.mm(x.float(), x.float()).dtype == tfun._LOW_PRECISION["dtype"]
    assert ns.s(x).dtype == torch.float32
    assert ns.c(x, x.float()).dtype == torch.float32


# ------------------------------------------------------------------ lists
#: JAX entries mapped to their torch twins, as the port's module says
#: (None: no twin of its own); an entry not named is its own twin
NUMPY_TWIN = {"power": "pow"}
LAX_TWIN = {"dot": "linear", "dot_general": None, "conv": "conv2d",
            "conv_general_dilated": "conv2d",
            "conv_with_general_padding": "conv2d",
            "conv_transpose": "conv_transpose2d"}
# jax.nn.logsumexp is torch.logsumexp, in the torch fp32 list
NN_TWIN = {"standardize": "layer_norm", "logsumexp": None}


def _twins(names, table):
    return {table.get(n, n) for n in names} - {None}


def test_lists_keep_jax_classification():
    assert _twins(jlists.LOW_PRECISION_NUMPY, NUMPY_TWIN) == set(
        tlists.LOW_PRECISION_NUMPY)
    assert _twins(jlists.LOW_PRECISION_LAX, LAX_TWIN) <= set(
        tlists.LOW_PRECISION_LAX)
    assert _twins(jlists.FP32_NUMPY, NUMPY_TWIN) | {"logsumexp"} == set(
        tlists.FP32_NUMPY)
    assert _twins(jlists.FP32_NN, NN_TWIN) == set(tlists.FP32_NN)
    assert set(jlists.PROMOTE_NUMPY) == set(tlists.PROMOTE_NUMPY)
    assert set(jlists.SEQUENCE_NUMPY) == set(tlists.SEQUENCE_NUMPY)
    for names, mod in ((tlists.LOW_PRECISION_NUMPY, torch),
                       (tlists.FP32_NUMPY, torch),
                       (tlists.PROMOTE_NUMPY, torch),
                       (tlists.SEQUENCE_NUMPY, torch),
                       (tlists.LOW_PRECISION_LAX, F), (tlists.FP32_NN, F)):
        for n in names:
            assert callable(getattr(mod, n)), n


def test_cast_namespaces_match_jax(low_precision):
    rng = np.random.RandomState(2)
    a = rng.randn(4, 4).astype(np.float32)
    jfun.set_low_precision_dtype(jnp.float16)
    tfun.set_low_precision_dtype(torch.float16)
    jns, tns = jlists.cast_namespaces(), amp.cast_namespaces()
    jy = jns.numpy.matmul(jnp.asarray(a), jnp.asarray(a))
    ty = tns.torch.matmul(torch.from_numpy(a), torch.from_numpy(a))
    assert ty.dtype == JAX_DTYPE[jy.dtype.type] == torch.float16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2e-3, atol=2e-3)
    h = a.astype(np.float16)
    jp = jns.nn.softmax(jnp.asarray(h))
    tp = tns.functional.softmax(torch.from_numpy(h), -1)
    assert tp.dtype == JAX_DTYPE[jp.dtype.type] == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    js = jns.numpy.sum(jnp.asarray(h))
    ts = tns.torch.sum(torch.from_numpy(h))
    assert ts.dtype == JAX_DTYPE[js.dtype.type] == torch.float32
    np.testing.assert_allclose(ts.item(), float(js), rtol=1e-6)
    # names off the lists pass through, the namespaces untouched
    assert tns.torch.relu is torch.relu and tns.functional.gelu is F.gelu
    assert torch.matmul(torch.from_numpy(a),
                        torch.from_numpy(a)).dtype == torch.float32


def test_patch_casts_torch_and_restores_every_original(low_precision):
    originals = {(mod.__name__, n): getattr(mod, n)
                 for mod, names, _ in tlists._PLAN for n in names}
    tfun.set_low_precision_dtype(torch.float16)
    x = torch.randn(3, 3)
    handle = amp.patch()
    try:
        assert torch.matmul(x, x).dtype == torch.float16
        assert F.linear(x, x).dtype == torch.float16
        assert torch.sum(x.half()).dtype == torch.float32
        assert F.softmax(x.half(), -1).dtype == torch.float32
        assert torch.add(x.half(), x).dtype == torch.float32
    finally:
        handle.restore()
    for (mod, n), fn in originals.items():
        got = getattr(torch if mod == "torch" else F, n)
        assert got is fn, (mod, n)
    assert torch.matmul(x, x).dtype == torch.float32
    # the handle is a context manager too, and a second restore is a no-op
    with amp.patch():
        assert torch.exp(x.half()).dtype == torch.float32
    handle.restore()
    assert torch.exp(x.half()).dtype == torch.float16
