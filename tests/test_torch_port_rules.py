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

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite's parallel workers share the cores

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
                                    "attention_decode", "softmax",
                                    "dropout", "multi_tensor"])
def test_kernel_wrappers_have_no_fallback(module):
    """No ``try`` in a wrapper module, and each counts its launches (the
    mid rung through the short rung's launchers, with its own names)."""
    src = (ROOT / "apex_tpu_torch" / "ops" / f"{module}.py").read_text()
    assert not re.search(r"^\s*try\s*:", src, re.MULTILINE)
    if module == "attention_mid":
        assert "launch_fwd(_entry, (KERNEL, KERNEL_SEG)" in src
        assert "launch_bwd(_entry, (KERNEL_BWD, KERNEL_BWD_SEG)" in src
    else:
        assert "count_launch(" in src


def _fake_launch(monkeypatch, mod, symbol):
    """A stand-in for the C entry ``symbol`` that records its arguments
    and reports success, so a launcher runs on CPU tensors (nothing is
    launched): ``(calls, entry)``, ``entry`` in place of ``mod._entry``,
    which also takes the operands' dtype (fp16's library is its own)."""
    from apex_tpu_torch.ops import attention_short

    calls = []

    def entry(name, dtype=torch.float32):
        assert name == symbol and dtype in attention_short.DTYPES
        return None, lambda *args: calls.append(args) or 0

    monkeypatch.setattr(attention_short, "stream_of", lambda t: None)
    monkeypatch.setattr(mod, "stream_of", lambda t: None, raising=False)
    return calls, entry


@pytest.mark.parametrize("module", ["attention_short", "attention_mid"])
@pytest.mark.parametrize("segs", [False, True])
def test_backward_wrappers_count_their_launches(monkeypatch, module, segs):
    """The forward and backward entries count under their own names (the
    segment instances under ``<name>_seg``), once per call of the C
    entry, which gets as many arguments as its ctypes types."""
    from apex_tpu_torch.ops import attention_short as short
    from apex_tpu_torch.ops.common import launch_counts, reset_launch_counts

    mod = importlib.import_module(f"apex_tpu_torch.ops.{module}")
    rung = module.split("_")[1]
    assert (mod.KERNEL, mod.KERNEL_BWD) == (f"{rung}_fwd", f"{rung}_bwd")
    assert (mod.KERNEL_SEG, mod.KERNEL_BWD_SEG) == (f"{rung}_fwd_seg",
                                                   f"{rung}_bwd_seg")
    q = torch.zeros((2, 3, 16, 64))
    ids = (torch.zeros((2, 16), dtype=torch.int64),) * 2 if segs else (
        None, None)
    reset_launch_counts()
    for symbol, call in (
            (mod.KERNEL,
             lambda entry: short.launch_fwd(
                 entry, (mod.KERNEL, mod.KERNEL_SEG), q, q, q, True, 0.1,
                 *ids)),
            (mod.KERNEL_BWD,
             lambda entry: short.launch_bwd(
                 entry, (mod.KERNEL_BWD, mod.KERNEL_BWD_SEG), q, q, q, q, q,
                 torch.zeros((2, 3, 16)), None, True, 0.1, *ids))):
        calls, entry = _fake_launch(monkeypatch, mod, symbol)
        call(entry)
        (args,) = calls
        assert len(args) == len(mod.ARGTYPES[symbol])
        # the ids pointers are null without ids, and heads follows bh
        assert (args[3] is None) == (not segs)
        assert args[args.index(6) + 1] == 3
    want = ({mod.KERNEL_SEG: 1, mod.KERNEL_BWD_SEG: 1} if segs
            else {mod.KERNEL: 1, mod.KERNEL_BWD: 1})
    assert {k: v for k, v in launch_counts().items() if v} == want


@pytest.mark.parametrize("segs", [False, True])
def test_flash_backward_wrappers_count_their_launches(monkeypatch, segs):
    """The flash rung's forward, dK/dV and dQ entries count under their
    own names (``_seg`` with ids), once each per call of their C entry."""
    from apex_tpu_torch.ops import attention_flash as mod
    from apex_tpu_torch.ops.common import launch_counts, reset_launch_counts

    assert (mod.KERNEL, mod.KERNEL_DKV, mod.KERNEL_DQ) == (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    q = torch.zeros((6, 16, 64))
    row = torch.zeros((6, 16))
    ids = (torch.zeros((2, 16), dtype=torch.int32),) * 2 if segs else (
        None, None)
    reset_launch_counts()
    for symbol, rest, outs in ((mod.KERNEL, (), (q, row)),
                               (mod.KERNEL_DKV, (q, row, row), (q, q)),
                               (mod.KERNEL_DQ, (q, row, row), (q,))):
        calls, entry = _fake_launch(monkeypatch, mod, symbol)
        monkeypatch.setattr(mod, "_entry", entry)
        mod._launch(symbol, q, q, q, ids, 3 if segs else None, rest, outs,
                    True, 0.1)
        (args,) = calls
        assert len(args) == len(mod.ARGTYPES[symbol])
        assert (args[3] is None) == (not segs)
    names = [mod.SEG[k] if segs else k
             for k in (mod.KERNEL, mod.KERNEL_DKV, mod.KERNEL_DQ)]
    assert {k: v for k, v in launch_counts().items() if v} == dict.fromkeys(
        names, 1)


@pytest.mark.parametrize("module", ["attention_short", "attention_mid",
                                    "attention_flash"])
@pytest.mark.parametrize("segs", [False, True])
def test_dropout_instances_count_under_their_own_names(monkeypatch, module,
                                                      segs):
    """A launch with dropout counts as ``<name>_drop`` (``<name>_seg_drop``
    with ids) and hands the C entry the seed's bits, the keep threshold
    and the fp32 ``1 / (1 - rate)`` just before the stream; without
    dropout the three are 0 (the instance without dropout)."""
    from apex_tpu_torch.ops import attention_short as short
    from apex_tpu_torch.ops.common import launch_counts, reset_launch_counts

    mod = importlib.import_module(f"apex_tpu_torch.ops.{module}")
    drop = (0.1, 0xF0000001)
    want_args = (0xF0000001 - (1 << 32), 15099494, float(np.float32(1 / 0.9)))
    assert short.drop_operands(drop) == want_args
    assert short.drop_operands(None) == (0, 0, 0.0)
    ids = (torch.zeros((2, 16), dtype=torch.int32),) * 2 if segs else (
        None, None)
    reset_launch_counts()
    if module == "attention_flash":
        q, row = torch.zeros((6, 16, 64)), torch.zeros((6, 16))
        launches = [(sym, lambda e, sym=sym, rest=rest, outs=outs:
                     mod._launch(sym, q, q, q, ids, 3 if segs else None,
                                 rest, outs, True, 0.1, drop))
                    for sym, rest, outs in (
                        (mod.KERNEL, (), (q, row)),
                        (mod.KERNEL_DKV, (q, row, row), (q, q)),
                        (mod.KERNEL_DQ, (q, row, row), (q,)))]
        names = [(mod.SEG[k] if segs else k) + "_drop"
                 for k in (mod.KERNEL, mod.KERNEL_DKV, mod.KERNEL_DQ)]
    else:
        q = torch.zeros((2, 3, 16, 64))
        launches = [
            (mod.KERNEL, lambda e: short.launch_fwd(
                e, (mod.KERNEL, mod.KERNEL_SEG), q, q, q, True, 0.1, *ids,
                drop)),
            (mod.KERNEL_BWD, lambda e: short.launch_bwd(
                e, (mod.KERNEL_BWD, mod.KERNEL_BWD_SEG), q, q, q, q, q,
                torch.zeros((2, 3, 16)), None, True, 0.1, *ids, drop))]
        names = [(mod.KERNEL_SEG if segs else mod.KERNEL) + "_drop",
                 (mod.KERNEL_BWD_SEG if segs else mod.KERNEL_BWD) + "_drop"]
    for symbol, call in launches:
        calls, entry = _fake_launch(monkeypatch, mod, symbol)
        if module == "attention_flash":
            monkeypatch.setattr(mod, "_entry", entry)
        call(entry)
        (args,) = calls
        assert len(args) == len(mod.ARGTYPES[symbol])
        assert args[-4:-1] == want_args
    assert {k: v for k, v in launch_counts().items() if v} == dict.fromkeys(
        names, 1)


@pytest.mark.parametrize("module", ["attention_short", "attention_mid",
                                    "attention_flash"])
@pytest.mark.parametrize("segs, drop", [(False, False), (True, True)])
def test_bias_launches_count_under_their_own_names(monkeypatch, module, segs,
                                                   drop):
    """A launch with a bias counts as ``<name>_bias`` (after ``_seg`` and
    ``_drop``) and hands the C entry the fp32 bias's pointer right after
    the ids and its batch and head strides right after ``causal``, 0 on a
    broadcast dim; without a bias the pointer is null and the strides 0
    (the launches above)."""
    from apex_tpu_torch.ops import attention_short as short
    from apex_tpu_torch.ops.common import launch_counts, reset_launch_counts

    mod = importlib.import_module(f"apex_tpu_torch.ops.{module}")
    ids = (torch.zeros((2, 16), dtype=torch.int32),) * 2 if segs else (
        None, None)
    dr = (0.1, 7) if drop else None
    # a per-batch bias: (b, 1, sq, sk), its head dim broadcast
    bias = short.bias_slab("k", torch.randn(2, 1, 16, 16), 2, 3, 16, 16)
    tag = ("_seg" if segs else "") + ("_drop" if drop else "") + "_bias"
    reset_launch_counts()
    if module == "attention_flash":
        q, row = torch.zeros((6, 16, 64)), torch.zeros((6, 16))
        launches = [(sym, lambda e, sym=sym, rest=rest, outs=outs:
                     mod._launch(sym, q, q, q, ids, 3, rest, outs, True, 0.1,
                                 dr, bias))
                    for sym, rest, outs in (
                        (mod.KERNEL, (), (q, row)),
                        (mod.KERNEL_DKV, (q, row, row), (q, q)),
                        (mod.KERNEL_DQ, (q, row, row), (q,)))]
        names = [k + tag for k in (mod.KERNEL, mod.KERNEL_DKV, mod.KERNEL_DQ)]
    else:
        q = torch.zeros((2, 3, 16, 64))
        launches = [
            (mod.KERNEL, lambda e: short.launch_fwd(
                e, (mod.KERNEL, mod.KERNEL_SEG), q, q, q, True, 0.1, *ids,
                dr, bias)),
            (mod.KERNEL_BWD, lambda e: short.launch_bwd(
                e, (mod.KERNEL_BWD, mod.KERNEL_BWD_SEG), q, q, q, q, q,
                torch.zeros((2, 3, 16)), None, True, 0.1, *ids, dr, bias))]
        names = [mod.KERNEL + tag, mod.KERNEL_BWD + tag]
    for symbol, call in launches:
        calls, entry = _fake_launch(monkeypatch, mod, symbol)
        if module == "attention_flash":
            monkeypatch.setattr(mod, "_entry", entry)
        call(entry)
        (args,) = calls
        assert len(args) == len(mod.ARGTYPES[symbol])
        assert args[5] == bias.data_ptr()
        at = args.index(6)          # bh = 2 * 3, then heads, sq, sk, ...
        assert args[at + 1] == 3
        assert args[at + 7:at + 9] == (16 * 16, 0)
    assert {k: v for k, v in launch_counts().items() if v} == dict.fromkeys(
        names, 1)


@pytest.mark.parametrize("module", ["attention_short", "attention_mid",
                                    "attention_flash"])
@pytest.mark.parametrize("segs, drop", [(False, False), (True, True)])
def test_dbias_launches_count_under_their_own_names(monkeypatch, module, segs,
                                                    drop):
    """A backward launch that emits the bias's gradient counts as
    ``<name>_dbias`` in place of ``_bias`` (after ``_seg`` and ``_drop``)
    and hands the C entry a zero-filled fp32 ``(b*h, sq, sk)`` output right
    after its own outputs (the short and mid entries' dv, the flash dQ
    entry's dq); the forward and the flash dK/dV entry have none.  A dBias
    without a bias raises."""
    from apex_tpu_torch.ops import attention_short as short
    from apex_tpu_torch.ops.common import launch_counts, reset_launch_counts

    mod = importlib.import_module(f"apex_tpu_torch.ops.{module}")
    ids = (torch.zeros((2, 16), dtype=torch.int32),) * 2 if segs else (
        None, None)
    dr = (0.1, 7) if drop else None
    bias = short.bias_slab("k", torch.randn(2, 1, 16, 16), 2, 3, 16, 16)
    tag = ("_seg" if segs else "") + ("_drop" if drop else "") + "_dbias"
    reset_launch_counts()
    if module == "attention_flash":
        q, row = torch.zeros((6, 16, 64)), torch.zeros((6, 16))
        g = torch.zeros((6, 16, 16))
        symbol, at = mod.KERNEL_DQ, 10
        calls, entry = _fake_launch(monkeypatch, mod, symbol)
        monkeypatch.setattr(mod, "_entry", entry)
        mod._launch(symbol, q, q, q, ids, 3, (q, row, row), (q,), True, 0.1,
                    dr, bias, g)
        name, ptr = mod.KERNEL_DQ + tag, g.data_ptr()
        with pytest.raises(ValueError, match="dBias"):
            mod.run_bwd(mod.KERNEL_DKV, q, q, q, q, row, row, True,
                        scale=0.1, ids=ids, heads=3, drop=dr, slab=bias,
                        dbias=True)
    else:
        q = torch.zeros((2, 3, 16, 64))
        symbol, at = mod.KERNEL_BWD, 14
        calls, entry = _fake_launch(monkeypatch, mod, symbol)
        *grads, g = short.launch_bwd(
            entry, (mod.KERNEL_BWD, mod.KERNEL_BWD_SEG), q, q, q, q, q,
            torch.zeros((2, 3, 16)), None, True, 0.1, *ids, dr, bias, True)
        assert len(grads) == 3 and g.shape == (2, 3, 16, 16)
        assert g.dtype == torch.float32 and not g.any()
        name, ptr = mod.KERNEL_BWD + tag, g.data_ptr()
        with pytest.raises(ValueError, match="dBias needs a bias"):
            short.launch_bwd(entry, (mod.KERNEL_BWD, mod.KERNEL_BWD_SEG), q,
                             q, q, q, q, torch.zeros((2, 3, 16)), None, True,
                             0.1, *ids, dr, None, True)
    (args,) = calls
    assert len(args) == len(mod.ARGTYPES[symbol])
    assert args[5] == bias.data_ptr() and args[at] == ptr
    assert {k: v for k, v in launch_counts().items() if v} == {name: 1}


def test_contrib_attention_never_falls_back():
    """``impl="fast"`` goes through ``flash_attention`` (the kernels, their
    plain versions only on CPU tensors), never through the plain
    ``mha_reference``, whatever the options; no module of the slice has a
    ``try``."""
    from apex_tpu_torch.contrib import multihead_attn as mha

    for path in ("contrib/multihead_attn/__init__.py", "ops/attention.py"):
        # a port file, so the import rule above covers it
        assert ROOT / "apex_tpu_torch" / path in PORT_FILES
        src = (ROOT / "apex_tpu_torch" / path).read_text()
        assert not re.search(r"^\s*try\s*:", src, re.MULTILINE), path
    seen = []
    real = mha.flash_attention

    def spy(*args, **kw):
        seen.append(kw["bias_requires_grad"])
        return real(*args, **kw)

    def oracle(*args, **kw):
        raise AssertionError("impl='fast' ran the plain attention")

    mp = pytest.MonkeyPatch()
    mp.setattr(mha, "flash_attention", spy)
    mp.setattr(mha, "mha_reference", oracle)
    try:
        x = torch.randn((8, 2, 32), generator=torch.Generator().manual_seed(0))
        pad = torch.zeros((2, 8), dtype=torch.bool)
        pad[1, 5:] = True
        mask = torch.ones((8, 8), dtype=torch.bool).triu(1)
        m = mha.SelfMultiheadAttn(32, 4, dropout=0.1, bias=True,
                                  include_norm_add=True, device="cpu")
        m(x, key_padding_mask=pad, attn_mask=mask, rng=np.array(
            [0, 1], np.uint32)).sum().backward()
        mha.EncdecMultiheadAttn(32, 4, device="cpu")(x, x, pad)
    finally:
        mp.undo()
    assert seen == [False, False]


@pytest.mark.parametrize("name", ["SelfMultiheadAttn", "EncdecMultiheadAttn"])
def test_contrib_modules_keep_the_jax_signatures(name):
    """``forward`` takes the JAX ``apply``'s parameters less ``params``, in
    its order; the constructor the JAX one's, in its order, then only
    keyword-only parameters of its own (``device``, ``key``)."""
    import inspect

    port = getattr(importlib.import_module(
        "apex_tpu_torch.contrib.multihead_attn"), name)
    ref = getattr(importlib.import_module("apex_tpu.contrib.multihead_attn"),
                  name)
    assert _params(port.forward) == _params(ref.apply)
    ref_init = list(inspect.signature(ref.__init__).parameters)
    init = inspect.signature(port.__init__).parameters
    assert list(init)[:len(ref_init)] == ref_init
    assert [p for p in list(init)[len(ref_init):]
            if init[p].kind is not inspect.Parameter.KEYWORD_ONLY] == []


@pytest.mark.parametrize("module, symbol", [
    ("attention_short", "short_fwd"), ("attention_short", "short_bwd"),
    ("attention_mid", "mid_fwd"), ("attention_mid", "mid_bwd"),
    ("attention_flash", "flash_fwd"), ("attention_flash", "flash_bwd_dkv"),
    ("attention_flash", "flash_bwd_dq"),
    ("attention_decode", "paged_decode"),
    ("attention_decode", "paged_decode_int8"),
    ("attention_decode", "paged_decode_rows"),
    ("dequant_matmul", "dequant_matmul"), ("layer_norm", "ln_fwd"),
    ("layer_norm", "ln_bwd"), ("layer_norm", "ln_bwd_fold"),
    ("multi_tensor", "multi_tensor_scale"),
    ("multi_tensor", "multi_tensor_l2norm"),
    ("multi_tensor", "multi_tensor_adam"),
    ("multi_tensor", "multi_tensor_lamb")])
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


def test_decode_rows_and_tree_count_under_their_own_names():
    """The many-row instance counts a causal launch as
    ``paged_decode_rows`` and an ancestor launch as ``paged_decode_tree``,
    from the one place that launches it; both ride the
    ``paged_decode_rows`` C entry.  The softmax kernel counts as
    ``softmax_fwd``."""
    from apex_tpu_torch.ops import attention_decode as dec
    from apex_tpu_torch.ops import softmax as sm

    src = (ROOT / "apex_tpu_torch" / "ops" / "attention_decode.py").read_text()
    assert (dec.KERNEL_ROWS, dec.KERNEL_TREE) == ("paged_decode_rows",
                                                  "paged_decode_tree")
    assert src.count("count_launch(") == 1
    assert "_entry(KERNEL_ROWS if rows else kernel,\n" in src
    assert sm.KERNEL == "softmax_fwd"
    sm_src = (ROOT / "apex_tpu_torch" / "ops" / "softmax.py").read_text()
    assert sm_src.count("count_launch(") == 1
    assert "\nimport triton" not in sm_src


@pytest.mark.parametrize("module", [
    "serving.speculate", "serving.kv_cache", "serving.sampling",
    "serving.serve", "ops.softmax", "transformer.enums",
    "transformer.functional.fused_softmax", "random", "ops.dropout",
    "transformer.tensor_parallel.random", "ops.multi_tensor", "amp.scaler",
    "optimizers.fused_tail", "optimizers.fused_lamb",
    "optimizers.fused_mixed_precision_lamb", "optimizers.fused_sgd",
    "optimizers.fused_novograd", "optimizers.fused_adagrad",
    "optimizers.larc", "resilience.guard", "transformer.amp",
    "models.t5", "models.resnet", "utils.convnet", "parallel",
    "parallel.sync_batchnorm", "contrib.xentropy", "examples.imagenet_amp",
    "serving.graphs", "fleet", "fleet.router", "fleet.failover",
    "fleet.journal", "resilience.faults", "tools.load_gen",
    "telemetry", "telemetry.events", "telemetry.metrics", "telemetry.spans",
    "transformer.log_util", "resilience", "resilience.retry",
    "resilience.watchdog", "csrc", "checkpoint", "utils.autoresume",
    "data", "transformer.data", "tools.fault_drill", "transformer.utils",
    "testing", "normalization", "normalization.fused_layer_norm",
    "contrib.layer_norm", "mlp", "fused_dense", "reparameterization", "rnn",
    "contrib.groupbn", "contrib.bottleneck", "contrib.transducer",
    "contrib.sparsity", "pyprof", "pyprof.parse", "pyprof.prof",
    "tools.profile_r05", "tools.scale_mfu", "tools.memory_audit",
    "tools.kernel_validation", "tools.chaos_drill", "examples.dcgan_amp",
    "transformer.tensor_parallel.mappings", "transformer.tensor_parallel.data",
    "transformer.tensor_parallel.memory", "testing.distributed"])
def test_new_modules_are_port_files(module):
    """The modules of the serving slice, the softmax entry point, the
    PRNG and dropout, T5, ResNet and their helpers, the fleet tier, the
    telemetry, resilience and checkpoint tier, and the layer library are
    in the package (so the import rule above covers them)."""
    path = ROOT / "apex_tpu_torch" / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    assert path in PORT_FILES
    importlib.import_module(f"apex_tpu_torch.{module}")


def test_entry_points_default_to_the_gpu(monkeypatch):
    from apex_tpu_torch import random as prng
    from apex_tpu_torch.examples.gpt_pretrain import Trainer, parse_args
    from apex_tpu_torch.ops.dropout import dropout_mask
    from apex_tpu_torch.serving import KVCacheConfig, init_pools
    from apex_tpu_torch.examples import imagenet_amp
    from apex_tpu_torch.models import (GPTConfig, GPTModel, ResNet,
                                       ResNetConfig, T5Config, T5Model)
    from apex_tpu_torch.serving.serve import init_carry
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
    from apex_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the fused softmax's kernel needs a GPU: none here, so not available
    assert not FusedScaleMaskSoftmax().is_kernel_available(None, 1, 1, 1, 1)
    cfg = KVCacheConfig(num_layers=1, num_heads=1, head_dim=8, num_pages=2)
    args = parse_args(["--layers", "1", "--hidden", "32", "--heads", "1",
                       "--vocab", "64", "--seq", "16"])
    for call in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: init_pools(cfg), lambda: init_carry(2),
                 lambda: prng.uniform_tensor(prng.PRNGKey(0), (4,)),
                 lambda: dropout_mask(prng.PRNGKey(0), (4,), 0.1),
                 lambda: Trainer(args),
                 lambda: GPTModel(GPTConfig(num_layers=1, hidden_size=32,
                                            num_attention_heads=1,
                                            vocab_size=64)),
                 lambda: T5Model(T5Config(hidden_size=32, vocab_size=64)),
                 lambda: ResNet(ResNetConfig(depth=18, width=4)),
                 lambda: imagenet_amp.main(["--depth", "18"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


# ------------------------------------------------ signatures against JAX
#: the ops modules whose public entry points keep the JAX signatures
SIGNATURE_MODULES = ("attention", "attention_short", "attention_mid",
                     "layer_norm", "softmax", "attention_decode",
                     "dequant_matmul", "rope")
#: JAX parameters the port leaves out: the parameter tree (the port's
#: modules own their weights), the mesh and its axis, the PRNG key; and
#: the port's own ``device`` (JAX places arrays on its default device)
LEFT_OUT = {"params", "mesh", "axis_name", "key", "device"}


def _twins():
    """``(module, name)`` of every public name of the modules above that
    the JAX package's module of the same name also has."""
    out = []
    for module in SIGNATURE_MODULES:
        port = importlib.import_module(f"apex_tpu_torch.ops.{module}")
        ref = importlib.import_module(f"apex_tpu.ops.{module}")
        out += [(module, name) for name in port.__all__
                if callable(getattr(ref, name, None))]
    return out


def _params(fn):
    import inspect

    return [p for p in inspect.signature(fn).parameters if p not in LEFT_OUT]


@pytest.mark.parametrize("module, name", _twins(),
                         ids=lambda x: x if isinstance(x, str) else None)
def test_ops_entry_points_keep_the_jax_signatures(module, name):
    """The port's parameters are the JAX function's, in its order, less
    ``params``/``mesh``/``axis_name``/``key``."""
    port = getattr(importlib.import_module(f"apex_tpu_torch.ops.{module}"),
                   name)
    ref = getattr(importlib.import_module(f"apex_tpu.ops.{module}"), name)
    assert _params(port) == _params(ref)


#: JAX public names of ``apex_tpu.ops`` the port leaves out on purpose:
#: the TPU's tile choices and the Pallas/XLA dispatch seam (the port's
#: wrappers launch their kernel or raise, ``ops/common.py``)
TPU_ONLY = {"default_mid_blocks", "default_mid_block_bh", "run_kernel",
            "shape_struct", "KernelLoweringError", "tpu_compiler_params"}
#: and those that wait for their item of ROADMAP.md's queue A: the
#: quantized collectives and their residuals come with multi-GPU (A9)
NOT_YET = {"CompressionConfig", "as_compression_config",
           "comm_residual_sizes", "dequantize_blockwise",
           "hierarchical_residual_sizes", "init_residual",
           "quantize_blockwise", "quantized_all_gather", "quantized_psum",
           "quantized_reduce_scatter", "zero3_residual_sizes"}


def _jax_public_names():
    """``(module, name)`` of every name in the ``__all__`` of
    ``apex_tpu.ops`` and of each of its modules that has a port twin
    (``""`` is the package itself)."""
    from pathlib import Path

    ported = sorted(p.stem for p in
                    (Path(__file__).parent.parent / "apex_tpu_torch" / "ops")
                    .glob("*.py") if not p.stem.startswith("_"))
    out = []
    for module in [""] + ported:
        path = "apex_tpu.ops" + (f".{module}" if module else "")
        try:
            ref = importlib.import_module(path)
        except ImportError:
            continue                      # a module only the port has
        out += [(module, name) for name in sorted(getattr(ref, "__all__", ()))
                if name not in TPU_ONLY | NOT_YET]
    return out


@pytest.mark.parametrize("module, name", _jax_public_names(),
                         ids=lambda x: x if isinstance(x, str) else None)
def test_port_has_every_jax_ops_name(module, name):
    """Each public name of a JAX ``ops`` module (and of the package) is
    in the port's twin, but for the lists above: the twin check walks the
    port's ``__all__`` and cannot see a name the port lacks."""
    path = "apex_tpu_torch.ops" + (f".{module}" if module else "")
    port = importlib.import_module(path)
    assert name in port.__all__ and hasattr(port, name), \
        f"{path} lacks {name}"


def test_signature_twins_cover_the_entry_points():
    names = {name for _, name in _twins()}
    assert {"flash_attention", "mha_reference", "fmha_short", "fmha_mid",
            "fmha_decode", "fused_layer_norm_affine", "fused_rms_norm_affine",
            "scaled_softmax", "scaled_masked_softmax",
            "scaled_upper_triang_masked_softmax", "dequant_matmul"} <= names


def test_attention_takes_the_jax_arguments_it_does_not_use():
    """``bias_requires_grad=False`` with no bias (the T5 and contrib
    callers), a dropout seed without dropout and the TPU tiles run; a
    constant bias runs, and a trainable one with
    ``bias_requires_grad=True`` too (dBias), with the plain reference's
    gradient; dropout with a seed runs; ``"xla"`` is no rung."""
    from apex_tpu_torch.ops import attention, attention_mid, attention_short

    q = torch.randn((1, 2, 16, 64), generator=torch.Generator().manual_seed(0))
    want = attention.mha_reference(q, q, q)
    entries = (
        (attention.flash_attention, dict(block_q=16, block_k=16,
                                         implementation="pallas")),
        (attention_short.fmha_short, dict(block_bh=4, implementation="short")),
        (attention_mid.fmha_mid, dict(block_q=16, block_k=16, block_bh=2,
                                      implementation="mid")))
    for fn, kw in entries:
        got = fn(q, q, q, bias_requires_grad=False, dropout_seed=3, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        bias = torch.randn((16, 16), generator=torch.Generator().manual_seed(1))
        got = fn(q, q, q, bias=bias.requires_grad_(), bias_requires_grad=False,
                 **kw)
        torch.testing.assert_close(got, attention.mha_reference(
            q, q, q, bias=bias), rtol=1e-5, atol=1e-5)
        trained, ref = (bias.detach().clone().requires_grad_()
                        for _ in range(2))
        fn(q, q, q, bias=trained, **kw).sum().backward()
        attention.mha_reference(q, q, q, bias=ref).sum().backward()
        torch.testing.assert_close(trained.grad, ref.grad, rtol=5e-5,
                                   atol=5e-5)
        # dropout is ported: with a seed it runs (the reference's mask)
        got = fn(q, q, q, dropout_rate=0.1, dropout_seed=1, **kw)
        torch.testing.assert_close(got, attention.mha_reference(
            q, q, q, dropout_rate=0.1, dropout_seed=1), rtol=1e-5,
            atol=1e-5)
        with pytest.raises(ValueError, match="implementation"):
            fn(q, q, q, implementation="xla")


def test_every_c_entry_is_typed():
    """Each C entry of every source (``int <name>(`` at the start of a
    line) is one ``test_c_entries_are_typed_as_the_source_declares``
    checks, so no prototype can grow past its ctypes types unseen."""
    from apex_tpu_torch.ops.common import KERNEL_SOURCES

    checked = {
        ("attention_short", "short_fwd"), ("attention_short", "short_bwd"),
        ("attention_mid", "mid_fwd"), ("attention_mid", "mid_bwd"),
        ("attention_flash", "flash_fwd"), ("attention_flash", "flash_bwd_dkv"),
        ("attention_flash", "flash_bwd_dq"),
        ("attention_decode", "paged_decode"),
        ("attention_decode", "paged_decode_int8"),
        ("attention_decode", "paged_decode_rows"),
        ("dequant_matmul", "dequant_matmul"), ("layer_norm", "ln_fwd"),
        ("layer_norm", "ln_bwd"), ("layer_norm", "ln_bwd_fold"),
        ("multi_tensor", "multi_tensor_scale"),
        ("multi_tensor", "multi_tensor_l2norm"),
        ("multi_tensor", "multi_tensor_adam"),
        ("multi_tensor", "multi_tensor_lamb")}
    found = set()
    for source in KERNEL_SOURCES:
        src = (ROOT / "apex_tpu_torch" / "csrc" / f"{source}.cu").read_text()
        found |= {(source, name) for name in
                  re.findall(r"^int (\w+)\(", src, re.MULTILINE)}
    assert found == checked


# ----------------------------------------- faults C2, C3, C5 (ROADMAP C)
def test_sample_takes_the_jax_key_second():
    """C2: ``sample(logits, key, temperature, ...)`` as in JAX; the key is
    unused at temperature 0 and required above it (JAX's ValueError), a
    key gives JAX's draw, and ``generate(key=)`` does not move a greedy
    stream."""
    import inspect

    import jax

    from apex_tpu.serving import sampling as jsampling
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.random import PRNGKey
    from apex_tpu_torch.serving import sampling

    assert list(inspect.signature(sampling.sample).parameters) == list(
        inspect.signature(jsampling.sample).parameters)
    logits = torch.randn((3, 11), generator=torch.Generator().manual_seed(2))
    want = sampling.greedy(logits)
    assert torch.equal(sampling.sample(logits, None, 0.0), want)
    assert torch.equal(sampling.sample(logits, object(), 0.0), want)
    with pytest.raises(ValueError, match="PRNG key"):
        sampling.sample(logits, None, 0.7)
    with pytest.raises(ValueError, match="PRNG key"):
        jsampling.sample(logits.numpy(), None, 0.7)
    np.testing.assert_array_equal(
        sampling.sample(logits, PRNGKey(4), 0.7).numpy(),
        np.asarray(jsampling.sample(logits.numpy(), jax.random.PRNGKey(4),
                                    0.7)))
    model = GPTModel(GPTConfig(vocab_size=32, num_layers=1, hidden_size=16,
                               num_attention_heads=2,
                               max_position_embeddings=32),
                     device="cpu", seed=1)
    prompts = np.array([[3, 4, 5, 6], [7, 8, 0, 0]])
    assert model.generate(prompts, [4, 2], 4, page_size=4,
                          key=PRNGKey(9)) == \
        model.generate(prompts, [4, 2], 4, page_size=4)


def test_decode_fns_carry_the_jax_fields():
    """C3: ``GPTDecodeFns`` has the JAX ``prefill_chunk``, ``speculate_k``,
    ``spec_tree`` and ``draft_source`` fields, filled as the callables
    are stamped."""
    import dataclasses

    from apex_tpu.models.gpt import GPTDecodeFns as JaxFns
    from apex_tpu_torch.models import GPTConfig, GPTDecodeFns, GPTModel
    from apex_tpu_torch.serving import KVCacheConfig
    from apex_tpu_torch.serving.speculate import offramp_tree

    port = {f.name for f in dataclasses.fields(GPTDecodeFns)}
    jax_only = {f.name for f in dataclasses.fields(JaxFns)} - port
    assert {"prefill_chunk", "speculate_k", "spec_tree",
            "draft_source"} <= port
    assert all(n.endswith("_jit") or n == "tp" for n in jax_only)
    model = GPTModel(GPTConfig(vocab_size=32, num_layers=1, hidden_size=16,
                               num_attention_heads=2,
                               max_position_embeddings=64,
                               compute_dtype=torch.float32),
                     device="cpu", seed=1)
    ccfg = KVCacheConfig(num_layers=1, num_heads=2, head_dim=8,
                         num_pages=17, page_size=4, max_seqs=2,
                         pages_per_seq=8, dtype=torch.float32)
    tree = offramp_tree(2)
    fns = model.decode_fns(ccfg, max_prompt_len=8, prefill_chunk=4,
                           speculate_k=2, spec_tree=tree)
    assert (fns.prefill_chunk, fns.speculate_k, fns.spec_tree) == (
        4, 2, tree)
    assert fns.prefill_chunk == fns.chunk.prefill_chunk
    assert (fns.speculate_k, fns.spec_tree, fns.draft_source) == (
        fns.spec.speculate_k, fns.spec.spec_tree, fns.spec.draft_source)
    plain = model.decode_fns(ccfg, max_prompt_len=8)
    assert (plain.prefill_chunk, plain.speculate_k, plain.spec_tree,
            plain.draft_source) == (None, None, None, None)


def test_gpt_config_takes_the_jax_fields():
    """C5: every JAX ``GPTConfig`` field is a port field; the context
    parallelism and MoE fields run at their defaults and raise naming
    A9 otherwise."""
    import dataclasses

    from apex_tpu.models import GPTConfig as JaxConfig
    from apex_tpu_torch.models import GPTConfig

    port = {f.name: f.default for f in dataclasses.fields(GPTConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert set(ref) <= set(port)
    for name in ("context_parallel", "num_experts", "moe_top_k",
                 "moe_capacity_factor", "moe_aux_weight",
                 "moe_router_z_loss_weight"):
        assert port[name] == ref[name]
    kw = dict(num_layers=1, hidden_size=16, num_attention_heads=2)
    GPTConfig(**kw, **{n: ref[n] for n in ("context_parallel", "moe_top_k",
                                           "moe_capacity_factor",
                                           "moe_aux_weight")})
    for bad in (dict(context_parallel=True), dict(num_experts=4),
                dict(moe_top_k=2), dict(moe_capacity_factor=2.0),
                dict(moe_aux_weight=0.1), dict(moe_router_z_loss_weight=1.0)):
        with pytest.raises(NotImplementedError, match="A9"):
            GPTConfig(**kw, **bad)


def _cuda_function(src: str, signature: str) -> str:
    """The text of the CUDA function whose definition starts with
    ``signature``, to its closing brace at the start of a line."""
    start = src.index(signature)
    return src[start:src.index("\n}\n", start) + 2]


def test_bf16_backward_runs_the_hopper_kernels():
    """The short/mid entries' bf16 (and fp16) backward launches the
    wgmma/TMA kernels of ``csrc/attention_bwd_sm90.cuh``, templated on the
    element type T, after the delta pass, and no bf16 (tensor-core
    ``kTC``, WMMA) path is left in the SIMT dK/dV and dQ kernels of
    ``attention_common.cuh``, which keep the fp32 instances."""
    csrc = ROOT / "apex_tpu_torch" / "csrc"
    common = (csrc / "attention_common.cuh").read_text()
    assert '#include "attention_bwd_sm90.cuh"' in common
    launch = _cuda_function(common, "cudaError_t launch_bwd(")
    bf16 = launch[launch.index("if constexpr (sizeof(T) == 2) {"):
                  launch.index("} else {")]
    assert "sm90::launch_bwd<D, ATTN_BWD_WARPGROUPS," in bf16
    assert "attn_bwd_" not in bf16
    header = (csrc / "attention_bwd_sm90.cuh").read_text()
    both = _cuda_function(header, "cudaError_t launch_bwd(")
    assert "launch_dkv<D, NC, SEGS, DROP, BIAS, T>" in both
    assert "launch_dq<D, NC, SEGS, DROP, BIAS, DBIAS, T>" in both
    assert "bwd_dkv_kernel<T, D, NC, SEGS, DROP, BIAS>\n      <<<" in header
    assert ("bwd_dq_kernel<T, D, NC, SEGS, DROP, BIAS, DBIAS>\n      <<<"
            in header)
    # no atomics (atomicAdd, PTX red/atom): the same bits on every call
    assert not re.search(r"atomic\w*\s*\(|\b(red|atom)\.", header)
    for kernel in ("attn_bwd_dkv_kernel(", "attn_bwd_dq_kernel("):
        body = _cuda_function(common, kernel)
        for word in ("kTC", "abT_tc", "ab_tc", "bf16", "wmma"):
            assert word not in body, (kernel, word)
    for layout in ("struct DkvLayout {", "struct DqLayout {"):
        assert "kTC" not in _cuda_function(common, layout)


def test_flash_bf16_backward_runs_the_hopper_kernels():
    """The flash entries' bf16 backward launches the wgmma/TMA kernels of
    ``csrc/attention_bwd_sm90.cuh``, each entry its own (``launch_dkv``
    the dK/dV kernel, ``launch_dq`` the dQ kernel), and keeps the SIMT
    kernels for fp32; no WMMA (tensor-core ``kTC``) path is left in
    ``attention_flash.cu`` or ``attention_tiles.cuh``, and neither has
    atomics: the same bits on every call."""
    csrc = ROOT / "apex_tpu_torch" / "csrc"
    flash = (csrc / "attention_flash.cu").read_text()
    tiles = (csrc / "attention_tiles.cuh").read_text()
    assert '#include "attention_bwd_sm90.cuh"' in flash
    for launcher, mine, other, simt in (
            ("cudaError_t launch_dkv(", "sm90::launch_dkv<", "launch_dq",
             "flash_bwd_dkv_kernel<D, SEGS, DROP, BIAS>\n"),
            ("cudaError_t launch_dq(", "sm90::launch_dq<", "launch_dkv",
             "flash_bwd_dq_kernel<D, SEGS, DROP, BIAS, DBIAS>\n")):
        body = _cuda_function(flash, launcher)
        split = body.index("} else {")
        bf16 = body[body.index("if constexpr (sizeof(T) == 2) {"):split]
        assert mine in bf16 and other not in bf16, launcher
        assert "_kernel" not in bf16, launcher
        assert simt in body[split:], launcher
    for name, src in (("attention_flash.cu", flash),
                      ("attention_tiles.cuh", tiles)):
        for word in ("kTC", "abT_tc", "ab_tc", "wmma", "nvcuda", "mma.h"):
            assert word not in src, (name, word)
        assert not re.search(r"atomic\w*\s*\(|\b(red|atom)\.", src), name


# ----------------------------------------- the layer library against JAX
#: the layer library's modules, each the twin of the JAX module of the
#: same path
LAYER_MODULES = ("transformer.utils", "testing", "normalization",
                 "normalization.fused_layer_norm", "contrib.layer_norm",
                 "mlp", "fused_dense", "reparameterization", "rnn",
                 "contrib.groupbn", "contrib.bottleneck",
                 "contrib.transducer", "contrib.sparsity")
#: JAX names whose twin has the port's platform in its name
RENAMED = {"TEST_WITH_TPU": "TEST_WITH_GPU", "skipIfNoTpu": "skipIfNoGpu"}
#: JAX parameters a port signature leaves out: flax's module plumbing
FLAX = {"self", "parent", "name"}


def _layer_twins():
    out = []
    for module in LAYER_MODULES:
        ref = importlib.import_module(f"apex_tpu.{module}")
        out += [(module, name) for name in ref.__all__]
    return out


@pytest.mark.parametrize("module, name", _layer_twins(),
                         ids=lambda x: x if isinstance(x, str) else None)
def test_layer_library_has_every_jax_name(module, name):
    """Each public name of the 13 JAX modules is public in the port's
    twin (the testing flags under their GPU names)."""
    port = importlib.import_module(f"apex_tpu_torch.{module}")
    name = RENAMED.get(name, name)
    assert name in port.__all__ and hasattr(port, name), \
        f"apex_tpu_torch.{module} lacks {name}"


def _signature(fn):
    import inspect

    sig = inspect.signature(fn)
    return ([p for p, v in sig.parameters.items()
             if p not in FLAX | LEFT_OUT
             and v.kind is not inspect.Parameter.KEYWORD_ONLY],
            {p for p, v in sig.parameters.items()
             if v.kind is inspect.Parameter.KEYWORD_ONLY})


@pytest.mark.parametrize("module, name", [
    (m, n) for m, n in _layer_twins() if n not in RENAMED],
    ids=lambda x: x if isinstance(x, str) else None)
def test_layer_library_keeps_the_jax_signatures(module, name):
    """A function takes the JAX function's parameters in its order (less
    ``params``/``key``); a class's constructor the JAX constructor's
    (flax fields for the norms), then keyword-only ``device``, ``key`` or
    ``generator``; a JAX ``__call__`` is the port's ``forward``."""
    import inspect

    port = getattr(importlib.import_module(f"apex_tpu_torch.{module}"), name)
    ref = getattr(importlib.import_module(f"apex_tpu.{module}"), name)
    if not callable(ref):
        return
    if inspect.isclass(ref):
        init = ref.__init__
        ref_pos, ref_kw = _signature(init)
        pos, kw = _signature(port.__init__)
        if "__call__" in vars(ref):
            assert _signature(port.forward)[0] == _signature(
                ref.__call__)[0]
    else:
        ref_pos, ref_kw = _signature(ref)
        pos, kw = _signature(port)
    assert pos == ref_pos
    assert ref_kw <= kw and kw - ref_kw <= {"device", "key", "generator"}


# ------------------------------------------- profiling and the one-GPU tools
#: the port's twins of the root tools and the JAX example: (port module,
#: the JAX file) and the JAX functions a twin replaces, with the reason
TOOL_TWINS = {
    "tools.profile_r05": ("tools/profile_r05.py", {}),
    "tools.scale_mfu": ("tools/scale_mfu.py", {}),
    "tools.chaos_drill": ("tools/chaos_drill.py", {}),
    "tools.kernel_validation": ("tools/kernel_validation.py", {}),
    "tools.memory_audit": ("tools/memory_audit.py", {
        "build_step": "ZeRO-3 against DDP: multi-GPU, queue A item 9",
        "run_memory_audit": "ZeRO-3 against DDP: multi-GPU, queue A item 9",
        "train_zero3": "ZeRO-3 training: multi-GPU, queue A item 9",
        "measure": "XLA's buffer assignment: run_train_audit reads "
                   "max_memory_allocated of a step on the card"}),
    "examples.dcgan_amp": ("examples/dcgan_amp.py", {
        "init_g": "G is an nn.Module (Generator) drawn at construction",
        "init_d": "D is an nn.Module (Discriminator) drawn at construction",
        "gen": "Generator.forward", "disc": "Discriminator.forward"}),
}


@pytest.mark.parametrize("module", sorted(TOOL_TWINS))
def test_tool_twins_keep_the_jax_functions(module):
    """Every public function of the JAX tool is in its twin, but those
    the twin replaces for a stated reason."""
    jax_file, replaced = TOOL_TWINS[module]
    names = set(re.findall(r"^def ([a-z]\w*)\(",
                           (ROOT / jax_file).read_text(), re.MULTILINE))
    port = importlib.import_module(f"apex_tpu_torch.{module}")
    assert set(replaced) <= names
    missing = {n for n in names - set(replaced) if not hasattr(port, n)}
    assert not missing, f"apex_tpu_torch.{module} lacks {sorted(missing)}"
    assert not any(hasattr(port, n) for n in replaced)


def test_pyprof_keeps_the_jax_names_and_signatures():
    import inspect

    from apex_tpu import pyprof as ref
    from apex_tpu_torch import pyprof as port

    assert set(ref.__all__) == set(port.__all__)
    for name in ref.__all__:
        a, b = getattr(ref, name), getattr(port, name)
        if inspect.isfunction(a):
            assert list(inspect.signature(a).parameters) == list(
                inspect.signature(b).parameters), name
    for sub in ("parse", "prof"):
        r = importlib.import_module(f"apex_tpu.pyprof.{sub}")
        p = importlib.import_module(f"apex_tpu_torch.pyprof.{sub}")
        assert set(r.__all__) <= set(p.__all__)


#: the root files the JAX tools write: the port's tools never do
JAX_TOOL_OUTPUTS = ("KERNELS_TPU.json", "PROFILE_r05.json", "PROFILE_r05.md",
                    "SCALE_MFU.json", "MEMORY_AUDIT.json",
                    "MEMORY_AUDIT_SERVE.json")


@pytest.mark.parametrize("module", ["profile_r05", "scale_mfu",
                                    "memory_audit", "kernel_validation",
                                    "chaos_drill"])
def test_port_tools_write_under_the_ignored_output_dir(module):
    """The port's tools write to ``--out``, by default under the
    git-ignored ``tool_out/`` (the chaos drill into its ``--root``),
    never to a root file that was there before the port."""
    src = (ROOT / "apex_tpu_torch" / "tools" / f"{module}.py").read_text()
    for name in JAX_TOOL_OUTPUTS:
        assert name not in src
    for name in re.findall(r'"([\w.]+\.(?:json|md))"', src):
        assert not (ROOT / name).exists(), name
    if module != "chaos_drill":
        assert '_REPO, "tool_out"' in src or "profile_r05._REPO" in src
    assert "tool_out/" in (ROOT / ".gitignore").read_text().split()


def test_metrics_report_stays_free_of_jax():
    """The port runs the root ``tools/metrics_report.py`` on its own
    stream, which stays legal while it imports neither jax nor apex_tpu."""
    src = (ROOT / "tools" / "metrics_report.py").read_text()
    assert not FORBIDDEN.search(src)


def _count_launch_calls():
    import ast

    for path in sorted((ROOT / "apex_tpu_torch" / "ops").glob("*.py")):
        if path.name == "common.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "count_launch":
                yield path.name, node


def test_every_launch_reports_its_cost():
    """Each module that counts launches (``count_launch(name)``, one
    argument) declares its entries' costs (``@kernel_entry(costs)``),
    the cost hook beside the counter."""
    import ast

    calls = list(_count_launch_calls())
    assert len(calls) >= 14
    for name, node in calls:
        assert len(node.args) == 1 and not node.keywords, \
            f"{name}:{node.lineno}"
    for name in sorted({name for name, _ in calls}):
        tree = ast.parse((ROOT / "apex_tpu_torch" / "ops" / name)
                         .read_text())
        entries = [d for node in ast.walk(tree)
                   if isinstance(node, ast.FunctionDef)
                   for d in node.decorator_list
                   if isinstance(d, ast.Call)
                   and getattr(d.func, "id", None) == "kernel_entry"]
        assert entries, name


@pytest.mark.parametrize("module", ["attention_short", "attention_mid",
                                    "attention_flash"])
def test_attention_launches_count_and_report_their_cost(monkeypatch, module):
    """A launch counts once, and its entry reports the same counter with
    its cost to every active recorder: the bound column's formulas (two
    products a visible pair forward, five a short/mid backward, four for
    flash dK/dV and three for dQ)."""
    from apex_tpu_torch.ops import attention_short as short
    from apex_tpu_torch.ops.common import (
        CostRecorder,
        launch_counts,
        reset_launch_counts,
    )

    mod = importlib.import_module(f"apex_tpu_torch.ops.{module}")
    pairs, d, numel, rows = 6 * 16 * 17 // 2, 64, 6 * 16 * 64, 96
    reset_launch_counts()
    plain = dict(scale=0.1, ids=(None, None), drop=None, slab=None)
    if module == "attention_flash":
        q, row = torch.zeros((6, 16, 64)), torch.zeros((6, 16))
        for symbol, rest, outs in ((mod.KERNEL, (), (q, row)),
                                   (mod.KERNEL_DKV, (q, row, row), (q, q)),
                                   (mod.KERNEL_DQ, (q, row, row), (q,))):
            _, entry = _fake_launch(monkeypatch, mod, symbol)
            monkeypatch.setattr(mod, "_entry", entry)
            mod._launch(symbol, q, q, q, (None, None), 3, rest, outs,
                        True, 0.1)
        with CostRecorder() as rec, CostRecorder() as inner:
            mod.run_fwd(q, q, q, True, heads=3, **plain)
            for symbol in (mod.KERNEL_DKV, mod.KERNEL_DQ):
                mod.run_bwd(symbol, q, q, q, q, row, row, True, heads=3,
                            **plain)
        want = {"flash_fwd": (4.0 * d * pairs, 4 * numel * 4 + rows * 4),
                "flash_bwd_dkv": (8.0 * d * pairs,
                                  6 * numel * 4 + 2 * rows * 4),
                "flash_bwd_dq": (6.0 * d * pairs,
                                 5 * numel * 4 + 2 * rows * 4)}
    else:
        q, lse = torch.zeros((2, 3, 16, 64)), torch.zeros((2, 3, 16))
        for symbol, call in (
                (mod.KERNEL, lambda e: short.launch_fwd(
                    e, (mod.KERNEL, mod.KERNEL_SEG), q, q, q, True, 0.1,
                    None, None)),
                (mod.KERNEL_BWD, lambda e: short.launch_bwd(
                    e, (mod.KERNEL_BWD, mod.KERNEL_BWD_SEG), q, q, q, q,
                    q, lse, None, True, 0.1, None, None))):
            _, entry = _fake_launch(monkeypatch, mod, symbol)
            call(entry)
        with CostRecorder() as rec, CostRecorder() as inner:
            mod._run_fwd(q, q, q, True, **plain)
            mod._run_bwd(q, q, q, q, q, lse, None, True, **plain)
        want = {mod.KERNEL: (4.0 * d * pairs, 4 * numel * 4 + rows * 4),
                mod.KERNEL_BWD: (10.0 * d * pairs,
                                 8 * numel * 4 + rows * 4)}
    assert {k: v for k, v in launch_counts().items() if v} == dict.fromkeys(
        want, 1)
    for r in (rec, inner):
        assert {k: (f, b) for k, (n, f, b) in r.kernels.items()} == want
        assert all(n == 1 for n, _, _ in r.kernels.values())
        assert r.flops == sum(f for f, _ in want.values())


def test_a_launch_opens_its_range_only_under_a_profiler():
    """``count_launch`` returns a ``record_function`` range named by the
    counter while a profiler runs, and a no-op context otherwise, so an
    unprofiled launch pays no profiler call."""
    from apex_tpu_torch.ops import common

    common.reset_launch_counts()
    with common.count_launch("fake_kernel") as ctx:
        assert ctx is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with common.count_launch("fake_kernel"):
            torch.zeros(4).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("fake_kernel") == 1
    assert common.launch_counts()["fake_kernel"] == 2


def test_every_wrapper_reports_its_cost_on_the_cpu():
    """Each wrapper's plain version (its CPU path) reports the counter and
    the cost its launch would, so a function counts the same on both."""
    from apex_tpu_torch import random as prng
    from apex_tpu_torch.ops import attention_decode as dec
    from apex_tpu_torch.ops import dropout as dr
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.ops import sampling as smp
    from apex_tpu_torch.ops import softmax as sm
    from apex_tpu_torch.ops.common import CostRecorder

    # the package exports the entry point under the module's name
    dq = importlib.import_module("apex_tpu_torch.ops.dequant_matmul")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 64), generator=g, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    b = torch.zeros(64, requires_grad=True)
    with CostRecorder() as rec:
        ln.fused_layer_norm_affine(x, w, b, (64,), 1e-5).sum().backward()
        sm.scaled_upper_triang_masked_softmax(torch.randn(2, 16, 16), 0.5)
        dr.dropout_fwd(torch.randn(4, 32), prng.PRNGKey(1), 0.1)
        smp.gumbel_argmax(torch.randn(2, 64), torch.zeros(
            (2, 2), dtype=torch.int64), None, 1.0)
        pages = torch.randn(5, 2, 4, 64)
        dec.fmha_decode(torch.randn(1, 2, 1, 64), pages, pages,
                        torch.tensor([[1, 2, 3, 4]], dtype=torch.int32),
                        torch.tensor([10], dtype=torch.int32))
        wq = dq.quantize_weight(torch.randn(64, 256), "int8", 128)
        dq.dequant_matmul(torch.randn(3, 64), wq["q8"], wq["scales"],
                          weight_dtype="int8")
        ts = [torch.randn(16), torch.randn(8)]
        mt.scale(ts, 0.5, out=ts)
        mt.l2norm(ts)
    want = {"ln_fwd": (8.0 * 512, 2 * 512 * 4 + 2 * 64 * 4 + 2 * 8 * 4),
            "ln_bwd": (20.0 * 512, 3 * 512 * 4 + 64 * 4 * 4 + 2 * 8 * 4),
            "softmax_fwd": (5.0 * 512, (2 * 136 + 512) * 4),
            "dropout": (float(dr.HASH_OPS) * 128, 2 * 128 * 4),
            "gumbel_argmax": (float(2 * 64 * smp.THREEFRY_OPS),
                              2 * 64 * 4 + 2 * 16),
            "paged_decode": (4.0 * 64 * 2 * 10, 2 * 128 * 4
                             + 2 * 10 * 2 * 64 * 4 + 4 * 5),
            "dequant_int8": (2.0 * 3 * 64 * 256 + 64 * 256,
                             3 * 64 * 4 + 64 * 256 + 64 * 2 * 4
                             + 3 * 256 * 4),
            "multi_tensor_scale": (2.0 * 24, 2 * 24 * 4),
            "multi_tensor_l2norm": (2.0 * 24, 24 * 4)}
    got = {k: (f, nb) for k, (n, f, nb) in rec.kernels.items()}
    assert got.pop("ln_bwd_fold")[0] > 0
    assert got == want


#: the ``torch.distributed`` calls the port could make
DIST_CALLS = ("all_reduce", "all_gather", "all_gather_into_tensor",
              "reduce_scatter_tensor", "broadcast", "barrier", "new_group",
              "get_world_size", "get_rank", "send", "recv", "reduce",
              "all_to_all_single", "init_process_group")


@pytest.mark.parametrize("llama", [False, True], ids=["learned", "llama"])
def test_tp1_paths_make_no_distributed_call(monkeypatch, llama):
    """At tensor-parallel world size 1 every region is the identity: a
    full ``loss`` and backward (the two-step and the fused cross entropy,
    the clip and the finite consensus) and a ``decode_fns`` prefill,
    decode, chunk and verify step call nothing of ``torch.distributed``."""
    import torch.distributed as dist

    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools)
    from apex_tpu_torch.transformer.amp import model_parallel_all_finite
    from apex_tpu_torch.transformer.tensor_parallel import clip_grad_norm

    calls = []
    for name in DIST_CALLS:
        if hasattr(dist, name):
            monkeypatch.setattr(
                dist, name, lambda *a, _n=name, **k: calls.append(_n))
    extra = dict(position_embedding="rope", activation="swiglu",
                 normalization="rmsnorm") if llama else {}
    for fused in (False, True):
        model = GPTModel(GPTConfig(vocab_size=32, num_layers=1,
                                   hidden_size=16, num_attention_heads=2,
                                   max_position_embeddings=64,
                                   compute_dtype=torch.float32,
                                   fused_ce=fused, fused_ce_chunk=8,
                                   **extra), device="cpu", seed=1)
        toks = torch.randint(0, 32, (2, 8))
        model.loss(toks, toks.roll(-1, 1)).backward()
        clip_grad_norm(model.parameters(), 1.0)
        model_parallel_all_finite(torch.tensor(True))
    ccfg = KVCacheConfig(num_layers=1, num_heads=2, head_dim=8,
                         num_pages=17, page_size=4, max_seqs=2,
                         pages_per_seq=8, dtype=torch.float32)
    for kw in ({}, dict(prefill_chunk=4, speculate_k=2)):
        fns = model.decode_fns(ccfg, max_prompt_len=8, **kw)
        assert fns.tp == 1 and fns.graphed
        batcher = ContinuousBatcher(
            fns.prefill, fns.decode, PagedKVCache(ccfg),
            init_pools(ccfg, "cpu"), max_prompt_len=8, chunk_fn=fns.chunk,
            prefill_chunk=kw.get("prefill_chunk"), spec_fn=fns.spec,
            speculate_k=kw.get("speculate_k"))
        comps = batcher.run([Request(uid=0, prompt=[1, 2, 3, 1, 2],
                                     max_new_tokens=6)])
        assert len(comps[0].tokens) == 6
    assert calls == []
