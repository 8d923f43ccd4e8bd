"""The JAX PRNG, bit for bit: threefry2x32 and the ``jax.random`` surface
the JAX package uses.

The JAX package draws its dropout masks from ``jax.random`` (hidden
dropout, ``apex_tpu/models/gpt.py:802-822``) and its attention-dropout
seeds from ``jax.random.bits`` (:763-778).  Torch has no threefry, so this
module writes it, for JAX's defaults: ``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True``, 64-bit types off.
Under those, for ``key = (k0, k1)``:

- ``PRNGKey(seed) = (0, seed mod 2**32)`` (the int64 seed cut to 32 bits);
- ``fold_in(key, d) = threefry2x32(key, (0, d))``;
- ``split(key, n)[i] = threefry2x32(key, (0, i))``;
- element ``n`` of ``bits(key, shape)`` (row-major) is ``y0 ^ y1`` of
  ``threefry2x32(key, (n >> 32, n & 0xffffffff))``, so a bulk draw is one
  independent hash per element;
- ``uniform`` is ``bitcast((bits >> 9) | 0x3F800000) - 1`` in float32, and
  ``bernoulli(key, p)`` is ``uniform < float32(p)``.

(``jax/_src/prng.py``: ``threefry_seed``, ``_threefry2x32_lowering``,
``iota_2x32_shape``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_uniform``, ``_bernoulli``.)

Keys live on the host: a key is a numpy ``(2,)`` uint32 array, the raw
JAX key itself (:func:`key_from_jax` takes one from JAX as numpy), and
key arithmetic is Python ints.  So deriving per-layer keys and attention seeds
never waits for the device, a seed reaches a kernel by value, and
recomputing a layer under remat draws the same masks from the same key,
with no RNG state to capture.  Torch's global generator is never touched.

The bulk draws over tensors (:func:`bits_tensor`, :func:`uniform_tensor`)
are plain PyTorch in int64 arithmetic masked to 32 bits: the CPU path and
the on-card oracle of the hidden-dropout kernel (``ops/dropout.py``),
which computes the same hash in one fused pass.

Serving keeps its keys on the device instead: one key a slot, a row of
the two words held in int64 (:func:`keys_tensor`), folded row by row with
a device value (the slot's context length) by :func:`fold_in_tensor`, so
a decode step that samples never reads a key back to the host.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["PRNGKey", "key_from_jax", "fold_in", "split", "bits", "uniform",
           "bernoulli", "threefry2x32", "bits_tensor", "uniform_tensor",
           "uniform_range_tensor", "seed_of", "fold_in_tensor", "keys_tensor", "threefry2x32_rows"]

MASK32 = 0xFFFFFFFF
#: the two rotation schedules of threefry2x32's five groups of 4 rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: threefry's key-schedule parity constant
PARITY = 0x1BD11BDA

Key = np.ndarray
Shape = Union[int, Sequence[int]]


def _key_words(key) -> Tuple[int, int]:
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise TypeError(f"a key is a (2,) uint32 array, got {k.dtype} "
                        f"{k.shape}")
    return int(k[0]), int(k[1])


def threefry2x32(key, x0, x1):
    """The threefry2x32 hash of the counter pair ``(x0, x1)`` under
    ``key``: 20 rounds in five groups with a key injection after each.
    ``x0``/``x1`` are Python ints or int64 tensors below 2**32; every
    add and shift is masked back to 32 bits."""
    return _rounds(*_key_words(key), x0, x1)


def _rounds(k0, k1, x0, x1):
    """threefry2x32 under the key words ``k0``/``k1`` (Python ints, or
    int64 tensors that broadcast against the counters)."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & MASK32)) & MASK32
    return x0, x1


def _hash(key, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """threefry2x32 of each counter pair, in Python ints: host draws are
    keys and seeds, a few words each."""
    pairs = [threefry2x32(key, int(a), int(b)) for a, b in zip(x0, x1)]
    return (np.array([p[0] for p in pairs], np.uint32).reshape(-1),
            np.array([p[1] for p in pairs], np.uint32).reshape(-1))


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: ``(0, seed mod 2**32)`` for an
    integer seed in int64's range (64-bit types off: JAX takes the seed as
    int64, converts it to int32 and so keeps its low 32 bits)."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} is out of int64's range")
    return np.array([0, seed & MASK32], dtype=np.uint32)


def key_from_jax(key) -> Key:
    """The port's key from a JAX raw key (``jax.random.PRNGKey(...)`` or
    ``jax.random.key_data(...)`` as numpy): the same two words."""
    k = np.asarray(key)
    if k.shape != (2,):
        raise ValueError(f"a JAX threefry key has shape (2,), got {k.shape}")
    return k.astype(np.uint32)


def fold_in(key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for ``0 <= data < 2**32``."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    y0, y1 = _hash(key, [0], [data])
    return np.array([y0[0], y1[0]], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2)`` uint32, row ``i`` the
    key of counter ``(0, i)``."""
    idx = np.arange(num, dtype=np.uint64)
    y0, y1 = _hash(key, idx >> np.uint64(32), idx & np.uint64(MASK32))
    return np.stack([y0, y1], axis=-1)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(map(int, shape))


def bits(key, shape: Shape = ()) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` as a numpy uint32 array."""
    shape = _shape(shape)
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    y0, y1 = _hash(key, idx >> np.uint64(32), idx & np.uint64(MASK32))
    return (y0 ^ y1).reshape(shape)


def seed_of(key) -> int:
    """``jax.random.bits(key, dtype=uint32)`` as a Python int: the
    attention-dropout seed a kernel takes by value."""
    return int(bits(key, ()))


def _to_unit(b: np.ndarray) -> np.ndarray:
    return ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)


def uniform(key, shape: Shape = ()) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    return _to_unit(bits(key, shape))


def bernoulli(key, p: float = 0.5, shape: Shape = ()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``
    (a weakly typed float32 in JAX): ``uniform < float32(p)``."""
    return uniform(key, shape) < np.float32(p)


# ------------------------------------------------------- tensor draws

def bits_tensor(key, shape: Shape, device=None) -> torch.Tensor:
    """:func:`bits` as an int64 tensor on ``device`` (values below
    2**32; the GPU unless ``device`` says otherwise), computed there in
    plain PyTorch."""
    shape = _shape(shape)
    n = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=resolve_device(device))
    y0, y1 = threefry2x32(key, n >> 32, n & MASK32)
    return (y0 ^ y1).reshape(shape)


def uniform_tensor(key, shape: Shape, device=None) -> torch.Tensor:
    """:func:`uniform` as a float32 tensor on ``device``: the top 23 bits
    as the mantissa of a number in [1, 2), minus 1 (exact in fp32)."""
    b = bits_tensor(key, shape, device)
    return (b >> 9).to(torch.float32) * np.float32(2.0 ** -23)


def uniform_range_tensor(key, shape: Shape, minval: float, maxval: float,
                         device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` as a
    float32 tensor: ``max(minval, u * (maxval - minval) + minval)`` with
    the bounds and their span in fp32 and the product and sum rounded
    once, as XLA fuses them on the CPU (the float64 product of two fp32
    values is exact)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    u = uniform_tensor(key, shape, device).double()
    x = (u * float(hi - lo) + float(lo)).float()
    return x.clamp_min(float(lo))


def _key_rows(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"device keys are (rows, 2), got "
                         f"{tuple(keys.shape)}")
    keys = keys.to(torch.int64) & MASK32
    return keys[:, 0], keys[:, 1]


def threefry2x32_rows(keys: torch.Tensor, x0: torch.Tensor,
                      x1: torch.Tensor):
    """:func:`threefry2x32` with one key a row: ``keys (R, 2)`` int64
    words, counters ``x0``/``x1`` of shape ``(R,)`` or ``(R, n)``; plain
    PyTorch in int64 masked to 32 bits."""
    k0, k1 = _key_rows(keys)
    if x0.ndim == 2:
        k0, k1 = k0[:, None], k1[:, None]
    return _rounds(k0, k1, x0, x1)


def keys_tensor(keys, device=None) -> torch.Tensor:
    """Host keys (one ``(2,)`` uint32 key or ``(R, 2)`` of them) as the
    device's ``(R, 2)`` int64 rows on ``device`` (the GPU unless it says
    otherwise)."""
    k = np.asarray(keys)
    if k.ndim == 1:
        k = k[None]
    if k.ndim != 2 or k.shape[1] != 2:
        raise ValueError(f"keys are (2,) or (rows, 2), got {k.shape}")
    return torch.as_tensor(k.astype(np.uint32).astype(np.int64),
                           device=resolve_device(device))


def fold_in_tensor(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """:func:`fold_in` row by row on the device: row ``r`` of the result
    is ``fold_in(keys[r], data[r])`` (``keys (R, 2)`` int64 words,
    ``data (R,)`` integers below 2**32), as int64 ``(R, 2)``."""
    data = data.to(torch.int64) & MASK32
    if data.shape != keys.shape[:1]:
        raise ValueError(f"data {tuple(data.shape)} does not match keys "
                         f"{tuple(keys.shape)}")
    y0, y1 = threefry2x32_rows(keys, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=1)
