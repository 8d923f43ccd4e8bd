"""The port's dequant matmul against the JAX package's Pallas kernels.

The same numpy activations and weights go through
``apex_tpu.ops.dequant_matmul.dequant_matmul(implementation="pallas")``
(``_int8_kernel`` / ``_int4_kernel`` in interpret mode on the CPU, as the
JAX package's own tests run them) and through
``apex_tpu_torch.ops.dequant_matmul.dequant_matmul`` on CPU tensors (the
CUDA kernel's plain version).  The quantized pools themselves are built
by each package and must be bit-identical.

Tolerances: fp32 x to 1e-5 relative (and 1e-5 of the output's scale
absolute), because both sum the same fp32 products in a different order;
bf16 x within one bf16 ulp at the output's magnitude, because both round
the fp32 result once and may fall on either side of a rounding boundary.
"""

import importlib
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTModel as JaxGPTModel
from apex_tpu_torch.transformer.tensor_parallel import QuantizedLinear

# the packages' ``ops`` re-export the function under the module's name
jd = importlib.import_module("apex_tpu.ops.dequant_matmul")
td = importlib.import_module("apex_tpu_torch.ops.dequant_matmul")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pool(weight_dtype, k, n, block, seed):
    w = np.random.RandomState(seed).randn(k, n).astype(np.float32)
    jq = jd.quantize_weight(jnp.asarray(w), weight_dtype, block)
    tq = td.quantize_weight(torch.from_numpy(w), weight_dtype, block)
    key = "q8" if weight_dtype == "int8" else "q4"
    np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
    np.testing.assert_array_equal(tq["scales"].numpy().view(np.int32),
                                  np.asarray(jq["scales"]).view(np.int32))
    return jq, tq, key


def _close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    top = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * top)
    else:
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert np.abs(got - want).max() <= ulp


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m, k, n, block", [(4, 32, 64, 16),
                                            (9, 64, 96, 16),
                                            (3, 48, 128, 32)])
def test_plain_matches_pallas(weight_dtype, dtype, m, k, n, block):
    jq, tq, key = _pool(weight_dtype, k, n, block, seed=m + k)
    x = np.random.RandomState(m).randn(m, k).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = jd.dequant_matmul(jnp.asarray(x, jdt), jq[key], jq["scales"],
                             weight_dtype=weight_dtype,
                             implementation="pallas")
    got = td.dequant_matmul(torch.from_numpy(x).to(tdt), tq[key],
                            tq["scales"], weight_dtype=weight_dtype)
    assert got.shape == (m, n) and got.dtype == tdt
    _close(got, want, dtype)
    ref = td.dequant_matmul_reference(
        torch.from_numpy(x).to(tdt), tq[key], tq["scales"],
        weight_dtype=weight_dtype, block_size=block)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_leading_dims_flattened():
    jq, tq, key = _pool("int4", 32, 64, 16, seed=3)
    x = np.random.RandomState(3).randn(2, 3, 32).astype(np.float32)
    got = td.dequant_matmul(torch.from_numpy(x), tq[key], tq["scales"],
                            weight_dtype="int4")
    assert got.shape == (2, 3, 64)
    flat = td.dequant_matmul(torch.from_numpy(x.reshape(6, 32)), tq[key],
                             tq["scales"], weight_dtype="int4")
    torch.testing.assert_close(got.reshape(6, 64), flat, rtol=0, atol=0)
    want = jd.dequant_matmul(jnp.asarray(x), jq[key], jq["scales"],
                             weight_dtype="int4", implementation="pallas")
    _close(got, want, "float32")


def test_block_size_recovered_from_scales():
    _, tq4, _ = _pool("int4", 32, 64, 16, seed=4)
    assert td.weight_pool_dtype(tq4) == "int4"
    assert td.weight_pool_block(tq4) == 16
    _, tq8, _ = _pool("int8", 32, 64, 32, seed=4)
    assert td.weight_pool_dtype(tq8) == "int8"
    assert td.weight_pool_block(tq8) == 32
    with pytest.raises(ValueError, match="not a quantized weight leaf"):
        td.weight_pool_dtype({"weight": None})


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_dequantize_weight_bit_identical(weight_dtype):
    jq, tq, _ = _pool(weight_dtype, 32, 64, 16, seed=5)
    np.testing.assert_array_equal(
        td.dequantize_weight(tq).numpy().view(np.int32),
        np.asarray(jd.dequantize_weight(jq)).view(np.int32))


def _messages(call):
    """The error each package raises for the same bad call."""
    out = []
    for mod, arr in ((jd, jnp.asarray), (td, torch.from_numpy)):
        args, kw = call(mod, arr)
        with pytest.raises(ValueError) as e:
            mod.dequant_matmul(*args, **kw)
        out.append(str(e.value))
    return out


@pytest.mark.parametrize("case", [
    "weight_dtype", "storage", "rank", "contraction", "tiling",
    "block_size", "halves"])
def test_validation_errors_match_jax(case):
    rng = np.random.RandomState(6)
    x = np.zeros((4, 32), np.float32)
    q8 = rng.randint(-127, 128, (32, 64)).astype(np.int8)
    s = np.ones((32, 4), np.float32)

    def call(mod, arr):
        wd = "int8"
        a, q, sc, kw = arr(x), arr(q8), arr(s), {}
        if case == "weight_dtype":
            wd = "fp8"
        elif case == "storage":
            q = arr(q8.astype(np.float32))
        elif case == "rank":
            q = arr(q8[None])
        elif case == "contraction":
            a = arr(np.zeros((4, 16), np.float32))
        elif case == "tiling":
            sc = arr(np.ones((32, 5), np.float32))
        elif case == "block_size":
            kw["block_size"] = 24
        else:
            wd, sc = "int4", arr(np.ones((32, 3), np.float32))
            q = arr(q8[:, :48])
        return (a, q, sc), dict(weight_dtype=wd, **kw)

    got_jax, got_port = _messages(call)
    assert got_port == got_jax


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_quantized_linear_matches_jax_apply_linear(weight_dtype, with_bias):
    """dequant product in x's dtype, then the bias cast to it and added,
    the order of ``GPTModel._apply_linear``."""
    jq, tq, key = _pool(weight_dtype, 32, 64, 16, seed=7)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 5, 32).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    leaf = dict(jq)
    if with_bias:
        leaf["bias"] = jnp.asarray(bias)
    want = JaxGPTModel._apply_linear(None, leaf, jnp.asarray(x))
    lin = QuantizedLinear(weight_dtype, tq[key], tq["scales"],
                          torch.from_numpy(bias) if with_bias else None)
    assert sorted(lin.state_dict()) == sorted(
        [key, "scales"] + (["bias"] if with_bias else []))
    _close(lin(torch.from_numpy(x)), want, "float32")


SMS = 132


def _units(plan):
    units = 1
    for g in plan.grid:
        units *= g
    return units


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 512, 2304])
@pytest.mark.parametrize("k, n", [(1024, 3072), (1024, 1024), (1024, 4096),
                                  (4096, 1024), (40, 96)])
def test_split_plan_covers_k(m, k, n, weight_dtype):
    """What the wrapper hands the kernels, for bf16 and fp32 x: the regime
    from m and x's dtype, every k row in exactly one split (whole 16-,
    64- or 32-row steps), the grid from the shapes (128 features a
    block), and the scratch:
    (splits, m, n) fp32 partials and one ticket counter per output tile,
    none at one split."""
    assert list(inspect.signature(td.dequant_plan).parameters) == [
        "m", "k", "n", "weight_dtype", "x_dtype", "sms"]
    nq = n // 2 if weight_dtype == "int4" else n
    features = -(-nq // (64 if weight_dtype == "int4" else 128))
    for x_dtype in (torch.bfloat16, torch.float32):
        plan = td.dequant_plan(m, k, n, weight_dtype, x_dtype, SMS)
        assert (plan.splits - 1) * plan.kc < k <= plan.splits * plan.kc
        assert plan.grid[-1] == plan.splits
        if m <= td.SKINNY_MAX_M:
            # decode: one block an SM at most, x's slice up to 1024 rows
            assert plan.regime == "decode" and plan.tile == 0
            assert len(plan.grid) == 2 and plan.grid[0] == features
            assert plan.kc % 16 == 0 and plan.kc <= 1024
            assert _units(plan) <= SMS or plan.splits == 1 or k > 1024
            # the feature tiles alone fill fewer than half the SMs: split
            if 2 * features <= SMS and k >= 256:
                assert plan.splits > 1
        elif x_dtype == torch.bfloat16 and nq % 16 == 0:
            assert plan.regime == "wgmma" and plan.grid[0] == features
            assert plan.tile in td.WGMMA_TILES and plan.kc % 64 == 0
            assert plan.grid[1] == -(-m // plan.tile)
        else:
            assert plan.regime == "tiled" and plan.tile == 0
            assert plan.grid[0] == features
            assert plan.kc % 32 == 0 and plan.grid[1] == -(-m // 128)
            # the output tiles alone fill fewer than half the SMs: split
            if _units(plan) // plan.splits < 66 and k >= 256:
                assert plan.splits > 1
        tiles = _units(plan) // plan.splits
        if plan.splits > 1:
            assert plan.workspace == plan.splits * m * n
            assert plan.counters == tiles
        else:
            assert plan.workspace == 0 and plan.counters == 0


@pytest.mark.parametrize("m, k, n, tile, waves", [(2304, 4096, 1024, 144, 1),
                                                  (2304, 1024, 3072, 256, 2),
                                                  (512, 1024, 4096, 128, 1)])
def test_wgmma_plan_fills_the_card(m, k, n, tile, waves):
    """The flagship's prefill shapes, none split: fc2 at 2304 tokens in one
    wave of 8 x 16 tiles of 144 tokens (not 144 tiles of 128 in two
    waves), qkv in two waves of 256-token tiles (fewer dequantizations of
    each weight than three of 144), fc1 at 512 tokens in one wave."""
    for wd in ("int8", "int4"):
        plan = td.dequant_plan(m, k, n, wd, torch.bfloat16, SMS)
        assert (plan.regime, plan.tile, plan.splits) == ("wgmma", tile, 1)
        assert -(-_units(plan) // SMS) == waves
        if waves == 1:
            assert _units(plan) / SMS > 0.95


def _hi_lo(x, w):
    """The wgmma kernel's arithmetic in plain torch: each fp32 weight split
    into hi = bf16(w) and lo = bf16(w - hi); bf16 x times either is exact
    in fp32; both products summed in fp32; not yet rounded."""
    hi = w.to(torch.bfloat16).float()
    lo = (w - hi).to(torch.bfloat16).float()
    xf = x.float()
    return torch.matmul(xf, hi) + torch.matmul(xf, lo)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
@pytest.mark.parametrize("block", [128, 16])
@pytest.mark.parametrize("k", [64, 1024, 4096])
def test_hi_lo_split_is_the_fp32_function(weight_dtype, block, k):
    """Two bf16 passes over w_hi and w_lo hold the plain fp32 version:
    before the rounding within 2^-12 of the output's scale, after it
    within one bf16 ulp, and under 1% of the rounded outputs differ from
    the plain version's.  A single bf16 pass (w rounded to 8 bits) is
    shown to miss the first bound and the last, so the test can tell them
    apart."""
    m, n = 16, 256
    rng = np.random.RandomState(k + block)
    w = torch.from_numpy(rng.randn(k, n).astype(np.float32))
    pool = td.quantize_weight(w, weight_dtype, block)
    q = pool["q8" if weight_dtype == "int8" else "q4"]
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
        torch.bfloat16)
    wf = td.dequantize_weight(pool)
    exact = torch.matmul(x.double(), wf.double())
    plain32 = torch.matmul(x.float(), wf)
    top = float(exact.abs().max())
    emu = _hi_lo(x, wf)
    assert float((emu.double() - exact).abs().max()) < 2.0 ** -12 * top
    assert float((emu - plain32).abs().max()) < 2.0 ** -12 * top
    one_pass = torch.matmul(x.float(), wf.to(torch.bfloat16).float())
    if k >= 1024:
        assert float((one_pass.double() - exact).abs().max()) \
            > 2.0 ** -12 * top
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    plain = td.dequant_matmul_reference(x, q, pool["scales"],
                                        weight_dtype=weight_dtype,
                                        block_size=block)
    assert float((emu.to(torch.bfloat16).float() - plain.float())
                 .abs().max()) <= ulp
    # elementwise, as the chip's phase 2 holds the kernel: under 1% of the
    # rounded outputs off the plain version's, where one pass moves ~40%
    flips = (emu.to(torch.bfloat16) != plain).float().mean().item()
    assert flips < 0.01
    assert (one_pass.to(torch.bfloat16) != plain).float().mean().item() \
        > 0.01
