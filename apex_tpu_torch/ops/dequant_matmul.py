"""Weight-dequantizing matmul: ``x @ dequant(W)`` from int8 or packed int4
weight pools — CUDA kernels and their plain version.

Replaces ``apex_tpu/ops/dequant_matmul.py::_int8_kernel`` and
``_int4_kernel``.  Layout as in the JAX package:

- int8: ``qweight (k, n) int8``, ``scales (k, n / block) fp32``, blocks
  along the output features, whole blocks only;
- int4: ``qweight (k, n / 2) int8`` packed bytes (:func:`pack_int4`'s
  halves layout: low nibble = output column ``c``, high nibble = column
  ``c + n/2``), ``scales (k, n / block) fp32``, ``n`` a multiple of
  ``2 * block`` so each half holds whole scale blocks.

The kernels (``csrc/dequant_matmul.cu``, which notes their design)
dequantize each weight element in fp32 with its own (row, block) scale,
sum the products in fp32 and round once to x's dtype, as the Pallas
bodies do; none writes the wide matrix to device memory.
:func:`dequant_plan` picks one from the shapes and x's dtype alone:

- ``decode`` (up to :data:`SKINNY_MAX_M` rows): fp32 FMAs on the CUDA
  cores over a ``cp.async`` ring of weight rows, k split to fill the SMs;
- ``wgmma`` (more rows, bf16 or fp16 x): the tensor cores, each
  dequantized weight split into ``hi = T(w)`` and ``lo = T(w - hi)`` in
  x's type T and both products accumulated in fp32, so the result is the
  fp32 sum to far less than an ulp of T; in fp16 each feature's weights
  are first scaled by a power of two (from its scales' largest), so that
  no lo part falls into fp16's subnormals, the sums scaled back in fp32,
  and each slab of 64 k rows is summed alone by the tensor cores and the
  slabs added on the CUDA cores (their accumulator truncates);
- ``tiled`` (more rows, fp32 x, or 16-bit x over int4 weights whose
  ``n / 2`` is not a multiple of 16): fp32 FMAs on the CUDA cores.

fp32 and bf16 x take ``csrc/dequant_matmul.cu``'s library, fp16 x that of
``dequant_matmul_f16.cu`` (the same code), counted as ``<name>_f16``.

A k split is merged inside the same launch: the last block of an output
tile adds the partials in split order (an ``atomicAdd`` ticket on a
counter the kernel leaves at 0), so every call is one launch and repeats
bit for bit.  The plain version, :func:`dequant_matmul_reference`,
materializes the wide fp32 matrix and runs one product.  No single
PyTorch call takes block-scaled int8/int4 weights, so the kernels have no
library yardstick.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from apex_tpu_torch.ops.common import (
    check, check_implementation, check_operands, count_launch, f16_name,
    load, split_scratch, stream_of,
)
from apex_tpu_torch.ops.quantization import (
    dequantize_rows,
    quantize_rows,
    quantize_rows_int4,
    unpack_int4,
)

__all__ = [
    "dequant_matmul",
    "dequant_matmul_reference",
    "quantize_weight",
    "dequantize_weight",
    "weight_pool_dtype",
    "weight_pool_block",
    "SKINNY_MAX_M",
]

#: launch counters, one per weight width
KERNELS = {"int8": "dequant_int8", "int4": "dequant_int4"}

#: rows the decode kernel takes; more rows go to a prefill kernel
SKINNY_MAX_M = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_REGIMES = {"decode": 0, "wgmma": 1, "tiled": 2}

#: the wgmma kernel's token tiles (its instances), the k rows of a slab;
#: fp16 x keeps a second set of fp32 sums beside the accumulators (each
#: slab's products summed alone, ``csrc/dequant_matmul.cu``), so its tiles
#: stop at 64 tokens
WGMMA_TILES = (32, 64, 128, 144, 256)
WGMMA_TILES_F16 = (32, 64)
_WG_K = 64
#: the decode kernel's largest k slice (its x slice sits in shared memory)
_DECODE_MAX_KC = 1024
#: the wgmma plan's cost model, fitted on an H100: a wave of blocks takes
#: 6.34e-5 us per k row per (token of the tile + 217), the 217 being the
#: A fragments' dequantization (``tools/dequant_ab.py --tiles``, qkv and
#: fc2 at 2304 tokens, every tile); a k split adds the ticket (3 us) and
#: the last block's read of every split's fp32 tile, about 20 GB/s for one
#: block (fc1 at 256 tokens: 128-token tiles split in two took 34.6 us
#: against 21.0 for 64-token tiles whole)
_US_PER_ROW_TOKEN = 6.34e-5
_ROW_OVERHEAD = 217
_SPLIT_US = 3.0
_MERGE_US_PER_BYTE = 1 / 2.0e4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, to: int) -> int:
    return _cdiv(x, to) * to


class DequantPlan(NamedTuple):
    """How a call runs, from its shapes and x's dtype alone: the
    ``regime`` (``"decode"``, ``"wgmma"`` or ``"tiled"``), the wgmma
    kernel's token ``tile`` (0 otherwise), ``kc`` k rows a split and
    ``splits`` of them, the launch ``grid`` (x: feature tiles of 128;
    y: token tiles, absent in decode; last: the splits), the fp32
    ``workspace`` elements of the partials ``(splits, m, n)`` and the int32
    ``counters`` of the merge tickets, one per output tile (both 0 at one
    split)."""

    regime: str
    tile: int
    kc: int
    splits: int
    grid: tuple
    workspace: int
    counters: int


def _wgmma_cost(m, k, tile, splits, feature_tiles, sms):
    """``(us, kc, splits)`` of the cost model below."""
    kc = _round_up(_cdiv(k, splits), _WG_K)
    splits = _cdiv(k, kc)
    units = feature_tiles * _cdiv(m, tile) * splits
    us = (_cdiv(units, sms) * kc * (tile + _ROW_OVERHEAD)
          * _US_PER_ROW_TOKEN)
    if splits > 1:
        us += _SPLIT_US + splits * tile * 128 * 4 * _MERGE_US_PER_BYTE
    return us, kc, splits


@functools.lru_cache(maxsize=4096)
def dequant_plan(m: int, k: int, n: int, weight_dtype: str,
                 x_dtype: torch.dtype, sms: int) -> DequantPlan:
    """The kernels' plan of a call.  Every block owns 128 output features
    (int8 columns, or 64 packed int4 columns and their high nibbles).

    - ``decode`` (m <= :data:`SKINNY_MAX_M`): blocks (feature tile, split);
      ``floor(sms / tiles)`` splits wanted (one block an SM), ``kc``
      rounded up to 16 and at most 1024 rows.
    - ``wgmma`` (bf16 or fp16 x; int4 needs ``n / 2 % 16 == 0``, TMA's 16-byte
      row stride): blocks (feature tile, token tile, split); the token
      tile from :data:`WGMMA_TILES` (fp16 x: :data:`WGMMA_TILES_F16`)
      and the splits (``kc`` a multiple of
      64) that minimise a cost model: waves over ``sms`` times ``kc *
      (tile + 217)``, plus the merge when k is split (the last block of a
      tile reads every split's fp32 tile).
    - ``tiled``: blocks (feature tile, 128-row tile, split); k split only
      when the tiles alone leave SMs idle (``kc`` a multiple of 32, at
      least 256).

    Neither the data nor the lengths enter: a launch can be captured in a
    CUDA graph."""
    int4 = weight_dtype == "int4"
    nq = n // 2 if int4 else n
    ftiles = _cdiv(nq, 64 if int4 else 128)
    if m <= SKINNY_MAX_M:
        regime, tile = "decode", 0
        want = max(1, sms // ftiles)
        kc = min(_DECODE_MAX_KC, _round_up(_cdiv(k, want), 16))
        splits = _cdiv(k, kc)
        grid = (ftiles, splits)
    elif x_dtype in (torch.bfloat16, torch.float16) and not (
            int4 and nq % 16):
        regime = "wgmma"
        best = None
        for tile in (WGMMA_TILES_F16 if x_dtype == torch.float16
                     else WGMMA_TILES):
            for s in range(1, min(16, _cdiv(k, _WG_K)) + 1):
                us, kc, splits = _wgmma_cost(m, k, tile, s, ftiles, sms)
                key = (us, splits, -tile)
                if best is None or key < best[0]:
                    best = (key, tile, kc, splits)
        _, tile, kc, splits = best
        grid = (ftiles, _cdiv(m, tile), splits)
    else:
        regime, tile = "tiled", 0
        tiles = ftiles * _cdiv(m, 128)
        want = _cdiv(sms, tiles)
        kc = (_round_up(k, 32) if want <= 1
              else max(256, _round_up(_cdiv(k, want), 32)))
        splits = _cdiv(k, kc)
        grid = (ftiles, _cdiv(m, 128), splits)
    tiles = 1
    for g in grid[:-1]:
        tiles *= g
    split = splits > 1
    return DequantPlan(regime, tile, kc, splits, grid,
                       splits * m * n if split else 0, tiles if split else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry(source: str = "dequant_matmul"):
    """The loaded library and its C entry, typed once."""
    lib = load(source)
    fn = lib.dequant_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def dequant_matmul_reference(x, qweight, scales, *, weight_dtype,
                             block_size):
    """The plain version: dequantize the wide fp32 matrix, one fp32
    product, the result in ``x``'s dtype."""
    return torch.matmul(x.to(torch.float32),
                        _dequantized(qweight, scales, weight_dtype,
                                     block_size)).to(x.dtype)


def _dequantized(qweight, scales, weight_dtype, block_size):
    if weight_dtype == "int8":
        return dequantize_rows(qweight, scales, block_size)
    return dequantize_rows(unpack_int4(qweight), scales, block_size)


def _dequant_cuda(x, qweight, scales, weight_dtype, bs):
    kernel = KERNELS[weight_dtype]
    m, k = x.shape
    int4 = weight_dtype == "int4"
    n = qweight.shape[1] * (2 if int4 else 1)
    if x.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: x must be one of {list(_DTYPES)}, got "
                         f"{x.dtype}")
    if scales.dtype != torch.float32:
        raise ValueError(f"{kernel}: scales must be fp32, got {scales.dtype}")
    if k % 8:
        raise ValueError(f"{kernel}: contraction {k} is not a multiple of 8")
    if int4 and ((n // 2) % 8 or bs % 8):
        raise ValueError(f"{kernel}: needs n/2 = {n // 2} and block {bs} "
                         "to be multiples of 8 (8-byte weight loads)")
    if not int4 and (n % 16 or bs % 16):
        raise ValueError(f"{kernel}: needs n = {n} and block {bs} to be "
                         "multiples of 16 (16-byte weight loads)")
    x = x.contiguous()
    check_operands(kernel, x, qweight, scales)
    for t in (x, qweight):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: operand not 16-byte aligned")
    plan = dequant_plan(m, k, n, weight_dtype, x.dtype,
                        _sm_count(x.device.index))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = stream_of(x)
    ws = cnt = None
    if plan.splits > 1:
        ws, cnt = split_scratch(x.device, stream.value, plan.workspace,
                           plan.counters)
    lib, fn = _entry(f16_name("dequant_matmul", x.dtype))
    count_launch(f16_name(kernel, x.dtype))
    err = fn(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
             out.data_ptr(), ws, cnt, m, k, n, bs, int(int4),
             _DTYPES[x.dtype], _REGIMES[plan.regime], plan.tile, plan.kc,
             plan.splits, stream)
    check(lib, kernel, err)
    return out


def dequant_matmul(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    *,
    weight_dtype: str,
    block_size: Optional[int] = None,
    implementation: Optional[str] = None,
) -> torch.Tensor:
    """``x @ W`` where ``W`` lives as block-quantized int8 or packed
    int4.  ``x (..., k)`` activations (fp32/bf16/fp16); ``qweight`` int8 —
    ``(k, n)`` for ``weight_dtype="int8"``, ``(k, n / 2)`` packed for
    ``"int4"``; ``scales (k, n / block_size)`` fp32.  ``block_size``
    defaults to the value the scale shape implies.  Returns ``(..., n)``
    in ``x``'s dtype.  A CUDA tensor runs the kernel, a CPU tensor the
    plain version; ``implementation`` None or ``"pallas"`` (the JAX
    argument) runs the kernel."""
    check_implementation("dequant_matmul", implementation)
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(
            f"weight_dtype must be 'int8' or 'int4', got "
            f"{weight_dtype!r}")
    if qweight.dtype != torch.int8:
        raise ValueError(
            f"qweight must be int8 storage, got "
            f"{str(qweight.dtype).replace('torch.', '')}")
    if qweight.ndim != 2 or scales.ndim != 2:
        raise ValueError(
            f"qweight/scales must be 2-D, got {tuple(qweight.shape)} / "
            f"{tuple(scales.shape)}")
    k = x.shape[-1]
    if qweight.shape[0] != k or scales.shape[0] != k:
        raise ValueError(
            f"contraction mismatch: x (..., {k}) vs qweight "
            f"{tuple(qweight.shape)} / scales {tuple(scales.shape)}")
    nb = scales.shape[1]
    n = qweight.shape[1] * (2 if weight_dtype == "int4" else 1)
    if nb < 1 or n % nb:
        raise ValueError(
            f"scales ({nb} blocks) do not tile the {n} output "
            f"features evenly")
    bs = n // nb
    if block_size is not None and int(block_size) != bs:
        raise ValueError(
            f"block_size={block_size} disagrees with the scale shape "
            f"({nb} blocks over {n} features imply {bs})")
    if weight_dtype == "int4" and (nb % 2 or (n // 2) % bs):
        raise ValueError(
            f"int4 halves layout needs whole scale blocks per half: "
            f"n={n} features, block_size={bs} "
            f"({nb} blocks — need an even count per half)")

    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x.is_cuda:
        out = _dequant_cuda(x2, qweight, scales, weight_dtype, bs)
    elif x.device.type == "cpu":
        out = dequant_matmul_reference(x2, qweight, scales,
                                       weight_dtype=weight_dtype,
                                       block_size=bs)
    else:
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    return out.reshape(*lead, n)


# ----------------------------------------------- weight-pool builders
def quantize_weight(w: torch.Tensor, weight_dtype: str,
                    block_size: int = 128, *,
                    leaf: str = "weight") -> Dict[str, torch.Tensor]:
    """ONE ``(k, n)`` weight matrix -> its quantized-pool leaf: ``{"q8":
    values, "scales": ...}`` for int8, ``{"q4": packed, "scales": ...}``
    for int4 (the JAX package's keys, so the weight bridge carries them
    as they are).  ``leaf`` names the weight in the strict
    block-validation errors."""
    if weight_dtype == "int8":
        q, s = quantize_rows(w, block_size, leaf=leaf)
        return {"q8": q, "scales": s}
    if weight_dtype == "int4":
        q, s = quantize_rows_int4(w, block_size, leaf=leaf)
        return {"q4": q, "scales": s}
    raise ValueError(
        f"weight_dtype must be 'int8' or 'int4', got {weight_dtype!r}")


def weight_pool_dtype(wq: Dict[str, Any]) -> str:
    """``"int8"`` / ``"int4"`` from a quantized-pool leaf's marker key."""
    if "q8" in wq:
        return "int8"
    if "q4" in wq:
        return "int4"
    raise ValueError(
        f"not a quantized weight leaf (no 'q8'/'q4' key): "
        f"{sorted(wq)}")


def weight_pool_block(wq: Dict[str, Any]) -> int:
    """The block size a quantized-pool leaf was built with, recovered
    from its shapes."""
    wd = weight_pool_dtype(wq)
    q = wq["q8"] if wd == "int8" else wq["q4"]
    n = q.shape[-1] * (2 if wd == "int4" else 1)
    return n // wq["scales"].shape[-1]


def dequantize_weight(wq: Dict[str, Any],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Materialize a quantized-pool leaf back to a wide matrix (the plain
    path and debugging; the serving forward never calls this)."""
    wd = weight_pool_dtype(wq)
    bs = weight_pool_block(wq)
    q = wq["q8"] if wd == "int8" else unpack_int4(wq["q4"])
    return dequantize_rows(q, wq["scales"], bs, dtype)
