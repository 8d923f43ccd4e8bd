"""The port's quantizers against the JAX package's, bit for bit.

The same numpy input goes through ``apex_tpu.ops.quantization`` and
``apex_tpu_torch.ops.quantization``; int8/int4 values, packed bytes and
the bit patterns of the fp32 scales must be identical (no tolerance: the
two run the same operations in the same order, and these are the bytes a
JAX weight pool or KV page carries into the port).  Covered: random
shapes at three magnitudes, rows that do not fill their last block, exact
.5 ties (round half to even), all-zero blocks (scale 1), the int4 nibble
round trip and its halves layout, and the strict per-leaf errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import quantization as jq
from apex_tpu_torch.ops import quantization as tq


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


def _rows(rows, n, scale, seed):
    x = (scale * np.random.RandomState(seed).randn(rows, n)).astype(
        np.float32)
    x[0, : min(n, 16)] = 0.0            # an all-zero block
    return x


@pytest.mark.parametrize("rows, n, block", [
    (7, 130, 16), (16, 256, 128), (33, 96, 36), (5, 64, 16), (3, 100, 256)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_rows_bit_identical(rows, n, block, scale):
    x = _rows(rows, n, scale, seed=rows + n)
    jv, js = jq.quantize_rows(jnp.asarray(x), block)
    tv, ts = tq.quantize_rows(torch.from_numpy(x), block)
    _same(tv, jv)
    _same(ts, js)
    _same(tq.dequantize_rows(tv, ts, block),
          jq.dequantize_rows(jv, js, block))
    _same(tq.dequantize_rows(tv, ts, block, torch.bfloat16).float(),
          jq.dequantize_rows(jv, js, block, jnp.bfloat16).astype(
              jnp.float32))


@pytest.mark.parametrize("rows, n, block", [
    (4, 32, 16), (16, 256, 128), (9, 96, 8), (2, 4, 2)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_rows_int4_bit_identical(rows, n, block, scale):
    x = _rows(rows, n, scale, seed=2 * rows + n)
    jv, js = jq.quantize_rows_int4(jnp.asarray(x), block)
    tv, ts = tq.quantize_rows_int4(torch.from_numpy(x), block)
    _same(tv, jv)
    _same(ts, js)
    _same(tq.dequantize_rows_int4(tv, ts, block),
          jq.dequantize_rows_int4(jv, js, block))


def test_ties_round_half_to_even():
    """A block whose max is 127 (int8) or 7 (int4) has scale 1 exactly,
    so these values are exact .5 ties: both packages round them to the
    even neighbour."""
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5],
                    np.float32)
    x8 = np.concatenate([[127.0], ties, np.zeros(7, np.float32)])[None]
    jv, js = jq.quantize_rows(jnp.asarray(x8), 16)
    tv, ts = tq.quantize_rows(torch.from_numpy(x8), 16)
    _same(tv, jv)
    _same(ts, js)
    assert ts.item() == 1.0
    assert tv[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 4, -4]
    x4 = np.concatenate([[7.0], ties[:6], [0.0]])[None].astype(np.float32)
    x4 = np.concatenate([x4, x4], axis=1)          # two blocks of 8
    jv, js = jq.quantize_rows_int4(jnp.asarray(x4), 8)
    tv, ts = tq.quantize_rows_int4(torch.from_numpy(x4), 8)
    _same(tv, jv)
    _same(ts, js)
    assert tq.unpack_int4(tv)[0, 1:7].tolist() == [0, 2, 2, 0, -2, -2]


def test_all_zero_blocks_get_scale_one():
    x = np.zeros((3, 32), np.float32)
    x[1, 16:] = 2.0
    tv, ts = tq.quantize_rows(torch.from_numpy(x), 16)
    jv, js = jq.quantize_rows(jnp.asarray(x), 16)
    _same(ts, js)
    assert ts[0].tolist() == [1.0, 1.0] and ts[1, 0].item() == 1.0
    assert not tv[0].any()
    tv, ts = tq.quantize_rows_int4(torch.from_numpy(x), 8)
    assert ts[0].tolist() == [1.0] * 4
    _same(ts, jq.quantize_rows_int4(jnp.asarray(x), 8)[1])


@pytest.mark.parametrize("rows, n", [(1, 2), (3, 8), (5, 64), (7, 130),
                                     (16, 256)])
def test_int4_pack_round_trip_and_bytes(rows, n):
    q = np.random.RandomState(n).randint(-8, 8, (rows, n)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(q))
    assert packed.shape == (rows, n // 2) and packed.dtype == torch.int8
    _same(packed, jq.pack_int4(jnp.asarray(q)))
    _same(tq.unpack_int4(packed), q)
    _same(tq.unpack_int4(packed),
          jq.unpack_int4(jq.pack_int4(jnp.asarray(q))))


def test_int4_halves_layout_pinned():
    """Packed column c = column c (low nibble) | column c + n/2 (high)."""
    packed = tq.pack_int4(torch.tensor([[1, -2, 3, -4]], dtype=torch.int8))
    p = packed.to(torch.int32) & 0xFF
    assert (((p & 0xF) ^ 8) - 8).tolist() == [[1, -2]]
    assert ((((p >> 4) & 0xF) ^ 8) - 8).tolist() == [[3, -4]]


def _message(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("call", [
    ("quantize_rows", (2, 96), (36,), dict(leaf="layers/fc1.weight")),
    ("quantize_rows_int4", (2, 96), (7,), dict(leaf="layers/qkv.weight")),
    ("quantize_rows_int4", (2, 96), (32,), dict(leaf="layers/fc2.weight")),
    ("quantize_rows_int4", (2, 95), (8,), dict(leaf="layers/fc2.weight")),
    ("quantize_rows_int4", (2, 96), (32,), {}),
    ("pack_int4", (2, 5), (), {}),
])
def test_strict_errors_name_the_leaf_as_jax_does(call):
    name, shape, args, kw = call
    x = np.ones(shape, np.int8 if name == "pack_int4" else np.float32)
    want = _message(getattr(jq, name), jnp.asarray(x), *args, **kw)
    got = _message(getattr(tq, name), torch.from_numpy(x), *args, **kw)
    assert got == want
    if kw:
        assert kw["leaf"] in got


def test_without_a_leaf_rows_pad_to_whole_blocks():
    x = np.random.RandomState(1).randn(2, 96).astype(np.float32)
    tv, ts = tq.quantize_rows(torch.from_numpy(x), 36)
    assert tv.shape == (2, 96) and ts.shape == (2, 3)
    _same(ts, jq.quantize_rows(jnp.asarray(x), 36)[1])


def test_stochastic_rounding_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tq.quantize_rows(torch.ones(2, 16), 16, rounding="stochastic")
