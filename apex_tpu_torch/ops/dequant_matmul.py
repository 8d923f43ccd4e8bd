"""Weight-dequantizing matmul: ``x @ dequant(W)`` from int8 or packed int4
weight pools — a CUDA kernel and its plain version.

Replaces ``apex_tpu/ops/dequant_matmul.py::_int8_kernel`` and
``_int4_kernel``.  Layout as in the JAX package:

- int8: ``qweight (k, n) int8``, ``scales (k, n / block) fp32``, blocks
  along the output features, whole blocks only;
- int4: ``qweight (k, n / 2) int8`` packed bytes (:func:`pack_int4`'s
  halves layout: low nibble = output column ``c``, high nibble = column
  ``c + n/2``), ``scales (k, n / block) fp32``, ``n`` a multiple of
  ``2 * block`` so each half holds whole scale blocks.

The kernel (``csrc/dequant_matmul.cu``, which notes its design) upcasts x
to fp32, dequantizes each weight element in fp32 with its own (row,
block) scale, sums in fp32 and rounds once to x's dtype, as the Pallas
bodies do; it never writes the wide matrix to device memory.  Up to
:data:`SKINNY_MAX_M` rows (decode) it streams the weights with k split
across blocks and the splits added in a fixed order by a second launch;
above that (prefill) it tiles rows and columns.  The plain version,
:func:`dequant_matmul_reference`, materializes the wide fp32 matrix and
runs one product.  No single PyTorch call takes block-scaled int8/int4
weights, so the kernel has no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional

import torch

from apex_tpu_torch.ops.common import (
    check, check_implementation, check_operands, count_launch, load,
    stream_of,
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

#: rows the decode kernel takes; more rows go to the tiled kernel
SKINNY_MAX_M = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def split_plan(m: int, k: int, n: int, sms: int):
    """``(kc, splits)``: the k rows of one block and the number of k
    splits, so that the column (and row) tiles times the splits give the
    ``sms`` multiprocessors work.  Decode blocks own 256 output columns
    and at most 256 k rows (their x slice sits in shared memory), about
    two blocks per SM; prefill blocks own 128 x 128 outputs and split k
    only when the tiles alone leave SMs idle."""
    if m <= SKINNY_MAX_M:
        tiles = -(-n // 256)
        kc = -(-k // max(1, -(-2 * sms // tiles)))
        kc = min(256, max(32, _round_up(kc, 16)))
    else:
        want = -(-sms // (-(-n // 128) * -(-m // 128)))
        kc = (_round_up(k, 32) if want <= 1
              else max(256, _round_up(-(-k // want), 32)))
    return kc, -(-k // kc)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry(symbol: str = "dequant_matmul"):
    """The loaded library and its C entry, typed once."""
    lib = load("dequant_matmul")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def dequant_matmul_reference(x, qweight, scales, *, weight_dtype,
                             block_size):
    """The plain version: dequantize the wide fp32 matrix, one fp32
    product, the result in ``x``'s dtype."""
    if weight_dtype == "int8":
        w = dequantize_rows(qweight, scales, block_size)
    else:
        w = dequantize_rows(unpack_int4(qweight), scales, block_size)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


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
    kc, splits = split_plan(m, k, n, _sm_count(x.device.index))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    work = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    lib, fn = _entry()
    count_launch(kernel)
    err = fn(x.data_ptr(), qweight.data_ptr(), scales.data_ptr(),
             out.data_ptr(), None if work is None else work.data_ptr(),
             m, k, n, bs, int(int4), _DTYPES[x.dtype], kc, splits,
             stream_of(x))
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
    int4.  ``x (..., k)`` activations (fp32/bf16); ``qweight`` int8 —
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
