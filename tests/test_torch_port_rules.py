"""Rules the port keeps, checked on its source.

- ``apex_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of ``apex_tpu``: the port carries its own copy of what it
  needs.
- Entry points default to the GPU and raise without one.
- Kernel wrappers never fall back to their plain versions on a CUDA
  tensor: no ``try`` in a wrapper module sends the work elsewhere.
"""

import ctypes
import importlib
import re
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
# the package's sources; its git-ignored build directory is not one
PORT_FILES = sorted(
    p for p in (ROOT / "apex_tpu_torch").rglob("*.py")
    if "_build" not in p.relative_to(ROOT).parts) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|apex_tpu)(?![\w])", re.MULTILINE)


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import apex_tpu",
                 "  from apex_tpu.ops import common", "import jax.numpy"):
        assert FORBIDDEN.search(line), line
    for line in ("import apex_tpu_torch", "from apex_tpu_torch import ops",
                 "import jaxtyping_like_name_not"):
        assert not FORBIDDEN.search(line), line


@pytest.mark.parametrize("module", ["layer_norm", "attention_short",
                                    "attention_mid", "attention_flash",
                                    "attention_decode"])
def test_kernel_wrappers_have_no_fallback(module):
    src = (ROOT / "apex_tpu_torch" / "ops" / f"{module}.py").read_text()
    assert not re.search(r"^\s*try\s*:", src, re.MULTILINE)
    assert "count_launch(KERNEL)" in src


@pytest.mark.parametrize("module", ["attention_short", "attention_mid"])
def test_backward_wrappers_count_their_launches(module):
    """The backward entries count under their own names, once per
    launch of the C entry."""
    mod = importlib.import_module(f"apex_tpu_torch.ops.{module}")
    src = (ROOT / "apex_tpu_torch" / "ops" / f"{module}.py").read_text()
    assert src.count("count_launch(KERNEL_BWD)") == 1
    assert mod.KERNEL_BWD == module.split("_")[1] + "_bwd"


def test_flash_backward_wrappers_count_their_launches():
    """The flash rung's dK/dV and dQ entries count under their own names,
    once each per launch of their C entry."""
    from apex_tpu_torch.ops import attention_flash as mod

    src = (ROOT / "apex_tpu_torch" / "ops" / "attention_flash.py").read_text()
    assert src.count("count_launch(KERNEL_DKV)") == 1
    assert src.count("count_launch(KERNEL_DQ)") == 1
    assert (mod.KERNEL, mod.KERNEL_DKV, mod.KERNEL_DQ) == (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


@pytest.mark.parametrize("module, symbol", [
    ("attention_short", "short_fwd"), ("attention_short", "short_bwd"),
    ("attention_mid", "mid_fwd"), ("attention_mid", "mid_bwd"),
    ("attention_flash", "flash_fwd"), ("attention_flash", "flash_bwd_dkv"),
    ("attention_flash", "flash_bwd_dq"),
    ("attention_decode", "paged_decode"),
    ("attention_decode", "paged_decode_int8"),
    ("dequant_matmul", "dequant_matmul")])
def test_c_entries_are_typed_as_the_source_declares(monkeypatch, module,
                                                    symbol):
    """The ctypes argument types of each C entry match its declaration
    in ``csrc/<module>.cu`` (a pointer or the stream is ``c_void_p``, an
    int ``c_int``, a float ``c_float``), set once per process."""
    mod = importlib.import_module(f"apex_tpu_torch.ops.{module}")
    src = (ROOT / "apex_tpu_torch" / "csrc" / f"{module}.cu").read_text()
    params = re.search(rf"^int {symbol}\(([^)]*)\)", src, re.MULTILINE)
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
            for p in params.group(1).split(",")]
    fake = types.SimpleNamespace(**{symbol: types.SimpleNamespace()})
    loads = []
    monkeypatch.setattr(mod, "load", lambda name: loads.append(name) or fake)
    mod._entry.cache_clear()
    try:
        lib, fn = mod._entry(symbol)
        assert mod._entry(symbol) == (lib, fn)
    finally:
        mod._entry.cache_clear()
    assert lib is fake and loads == [module]
    assert fn.argtypes == want and fn.restype is ctypes.c_int


def test_dequant_and_int8_decode_wrappers_count_their_launches():
    """The dequant wrapper launches under ``dequant_int8`` or
    ``dequant_int4`` from one place, with no fallback; the decode wrapper
    counts int8 pages under ``paged_decode_int8``; both sources are
    built."""
    from apex_tpu_torch.ops import attention_decode as dec
    from apex_tpu_torch.ops.common import KERNEL_SOURCES

    mod = importlib.import_module("apex_tpu_torch.ops.dequant_matmul")
    src = (ROOT / "apex_tpu_torch" / "ops" / "dequant_matmul.py").read_text()
    assert not re.search(r"^\s*try\s*:", src, re.MULTILINE)
    assert src.count("count_launch(") == 1
    assert mod.KERNELS == {"int8": "dequant_int8", "int4": "dequant_int4"}
    assert dec.KERNEL_INT8 == "paged_decode_int8"
    assert {"dequant_matmul", "attention_decode"} <= set(KERNEL_SOURCES)


def test_entry_points_default_to_the_gpu(monkeypatch):
    from apex_tpu_torch.examples.gpt_pretrain import Trainer, parse_args
    from apex_tpu_torch.serving import KVCacheConfig, init_pools
    from apex_tpu_torch.serving.serve import init_carry
    from apex_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = KVCacheConfig(num_layers=1, num_heads=1, head_dim=8, num_pages=2)
    args = parse_args(["--layers", "1", "--hidden", "32", "--heads", "1",
                       "--vocab", "64", "--seq", "16"])
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: init_pools(cfg), lambda: init_carry(2),
                 lambda: Trainer(args)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
