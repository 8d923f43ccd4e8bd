"""The port's ``pyprof`` against the JAX package's, on the CPU.

The twins of ``tests/test_pyprof.py``: markers keep semantics and name
the trace, ``parse`` reads a ``torch.profiler`` capture (``trace`` and
``telemetry.TraceTrigger``'s) into JAX's row keys, ``prof`` files them
into JAX's classes, ``utilization`` and ``summarize`` keep JAX's keys,
``Timers`` JAX's state machine.  Held against JAX:

- ``cost_analysis`` of a matmul chain counts exactly JAX's FLOPs (and
  bytes: each operand read once, each result written once);
- a one-layer GPT's forward counts within a band of JAX's (1.0-1.1x on
  these shapes): XLA counts its elementwise operations as FLOPs, the
  port only the products (``torch.utils.flop_counter``) and its kernels'
  reports; the port's attention kernel pays its head dim padded to 64
  (16 here) and only the causal pairs, XLA every score of its dense
  reference;
- ``classify`` files every HLO name of JAX's vocabulary as JAX does, and
  every kernel name of the port (launch counters, CUDA symbols, cuBLAS,
  ATen, cuDNN, NCCL, copies) in its class.

The cost hook: each wrapper's plain version reports what its launch
would (``flash_attention``'s count is PERF.md's bound formula on every
rung), and the operators inside a wrapper are not counted again.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import pyprof as jprof
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import convert, pyprof
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.ops import common
from apex_tpu_torch.ops.attention import flash_attention

torch.set_num_threads(1)  # the suite's parallel workers share the cores

#: the port's GPT forward over JAX's, in FLOPs (see the module docstring)
GPT_FLOPS_BAND = (1.0, 1.1)


def _randn(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _step(x, w):
    return torch.tanh(x @ w).sum()


def _trace(tmp_path, name="trace", steps=3, n=128):
    x, w = _randn(n, n), _randn(n, n, seed=1)
    log_dir = str(tmp_path / name)
    with pyprof.trace(log_dir):
        for _ in range(steps):
            _step(x, w)
    return log_dir


def test_annotate_preserves_semantics():
    @pyprof.annotate
    def f(x):
        return x * 2

    np.testing.assert_allclose(f(torch.ones(3)).numpy(), 2.0)
    assert f.__name__ == "f"


def test_annotate_name_reaches_the_parsed_trace(tmp_path):
    @pyprof.annotate(name="my_region")
    def f(x):
        return torch.sin(x) + 1

    with pyprof.trace(str(tmp_path / "t")):
        f(torch.ones(4))
    rows = pyprof.parse(str(tmp_path / "t"))
    (row,) = [r for r in rows if r["name"] == "my_region"]
    assert row["plane"] == "CPU" and row["line"].endswith(
        "(user annotations)")
    # an envelope: prof drops it, the op under it stays
    names = {n for c in pyprof.prof(rows) for n in c["ops"]}
    assert "my_region" not in names and "aten::sin" in names


def test_cost_analysis_matmul_chain_equals_jax():
    a, b, c = _randn(64, 128), _randn(128, 32, seed=1), _randn(32, 16, seed=2)

    def chain(a, b, c):
        return (a @ b) @ c

    want = jprof.cost_analysis(chain, *(x.numpy() for x in (a, b, c)))
    got = pyprof.cost_analysis(chain, a, b, c)
    assert got["flops"] == want["flops"] == 2 * (64 * 128 * 32 + 64 * 32 * 16)
    assert got["bytes accessed"] == want["bytes accessed"]
    assert got["kernels"] == {}


def test_gpt_layer_forward_count_beside_jax():
    sizes = dict(vocab_size=128, num_layers=1, hidden_size=64,
                 num_attention_heads=4, max_position_embeddings=64)
    if parallel_state.model_parallel_is_initialized():
        parallel_state.destroy_model_parallel()
    mesh = parallel_state.initialize_model_parallel(devices=jax.devices()[:1])
    try:
        jm = JaxGPTModel(JaxGPTConfig(**sizes, compute_dtype=jnp.float32,
                                      remat=False))
        rng = np.random.RandomState(0)
        params = jax.tree.map(
            lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32),
            jm.init(jax.random.PRNGKey(0)))
        toks = np.random.RandomState(1).randint(0, 128, (2, 32)).astype(
            np.int32)
        fwd = jax.shard_map(lambda p, t: jm.apply(p, t), mesh=mesh,
                            in_specs=(jm.param_specs(), P()), out_specs=P(),
                            check_vma=False)
        want = jprof.cost_analysis(fwd, params, jnp.asarray(toks))
    finally:
        parallel_state.destroy_model_parallel()
    tm = GPTModel(GPTConfig(**sizes, compute_dtype=torch.float32),
                  device="cpu")
    tm.load_state_dict(convert.params_from_jax(params))
    with torch.no_grad():
        got = pyprof.cost_analysis(tm.apply, torch.from_numpy(toks))
    ratio = got["flops"] / want["flops"]
    assert GPT_FLOPS_BAND[0] <= ratio <= GPT_FLOPS_BAND[1], ratio
    # the kernels' share: three norms and one causal attention (d padded
    # from 16 to 64), the rest the products
    assert {k: v["calls"] for k, v in got["kernels"].items()} == {
        "ln_fwd": 3, "short_fwd": 1}
    pairs = 2 * 4 * 32 * 33 // 2
    assert got["kernels"]["short_fwd"]["flops"] == 4 * 64 * pairs
    products = 2 * 2 * 32 * 64 * (3 * 64 + 64 + 4 * 64 + 4 * 64 + 128)
    assert got["operator flops"] == products


@pytest.mark.parametrize("rung, s", [("short", 128), ("mid", 640),
                                     ("pallas", 640)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_count_is_the_bound_formula(rung, s, causal):
    """Forward: two products of 2 d a visible pair, q, k, v read and out
    and the fp32 lse written; backward: five products (short, mid) or
    four + three (flash dK/dV, dQ), each entry's operands once (and the
    fp32 rows: lse, dlse, delta)."""
    b, h, d = 1, 2, 64
    q, k, v = (_randn(b, h, s, d, seed=i).requires_grad_() for i in range(3))
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    numel, rows = b * h * s * d, b * h * s
    fwd = pyprof.cost_analysis(flash_attention, q, k, v, causal=causal,
                               implementation=rung)
    name = {"short": "short", "mid": "mid", "pallas": "flash"}[rung]
    assert fwd["kernels"] == {f"{name}_fwd": {
        "calls": 1, "flops": 4.0 * d * pairs,
        "bytes accessed": 4.0 * numel * 4 + rows * 4}}
    assert fwd["operator flops"] == 0.0
    out = flash_attention(q, k, v, causal=causal, implementation=rung)
    dout = _randn(*out.shape, seed=7)
    bwd = pyprof.cost_analysis(out.backward, dout)
    if rung == "pallas":
        want = {"flash_bwd_dkv": (8.0 * d * pairs, (6 * numel) * 4
                                  + 2 * rows * 4),
                "flash_bwd_dq": (6.0 * d * pairs, (5 * numel) * 4
                                 + 2 * rows * 4)}
    else:
        # the mid rung's autograd hands its kernel the lse's cotangent too
        want = {f"{name}_bwd": (10.0 * d * pairs, 8 * numel * 4
                                + (1 + (rung == "mid")) * rows * 4)}
    assert {k: (v["flops"], v["bytes accessed"])
            for k, v in bwd["kernels"].items()} == want


def test_kernel_operators_are_not_counted_twice():
    """The plain attention runs products of its own on the CPU; under
    ``cost_analysis`` only its kernel's report counts."""
    q = _randn(1, 2, 128, 64)
    with common.CostRecorder() as rec:
        flash_attention(q, q, q)
    assert list(rec.kernels) == ["short_fwd"]
    got = pyprof.cost_analysis(flash_attention, q, q, q)
    assert got["operator flops"] == 0.0 == got["operator bytes accessed"]
    assert got["flops"] == rec.flops and got["bytes accessed"] == rec.bytes
    assert not common.in_kernel_entry()


def test_summarize_roofline():
    a = _randn(128, 128)
    rep = pyprof.summarize(lambda a, b: a @ b, a, a, peak_flops=1e12,
                           peak_bandwidth=1e11)
    want = jprof.summarize(lambda a, b: a @ b, a.numpy(), a.numpy(),
                           peak_flops=1e12, peak_bandwidth=1e11)
    assert set(rep) == set(want)
    assert rep["flops"] == want["flops"] == 2 * 128 ** 3
    assert rep["compute_bound"] == want["compute_bound"]
    assert rep["arithmetic_intensity"] > 0


def test_timers():
    timers = pyprof.Timers()
    t = timers("fwd")
    t.start()
    x = torch.ones((256, 256)) @ torch.ones((256, 256))
    t.stop(barrier_on=x)
    assert timers("fwd").elapsed(reset=False) > 0
    assert "fwd" in timers.log() and timers.log().startswith("time (ms) | ")
    t2 = timers("bwd")
    t2.start(barrier_on=[x, {"y": x}])
    with pytest.raises(AssertionError):
        t2.start()
    t2.stop()
    with pytest.raises(AssertionError):
        t2.stop()
    assert timers("fwd").elapsed() > 0 and timers("fwd").elapsed() == 0.0


def test_parse_per_op_table(tmp_path):
    rows = pyprof.parse(_trace(tmp_path))
    assert rows and set(rows[0]) == {"name", "count", "total_ms", "avg_ms",
                                     "pct", "plane", "line"}
    names = " ".join(r["name"] for r in rows)
    assert "aten::mm" in names and "aten::tanh" in names
    assert rows[0]["count"] >= 1 and rows[0]["total_ms"] > 0
    assert abs(sum(r["pct"] for r in rows) - 100.0) < 1e-6
    assert any(r["count"] >= 3 for r in rows)
    assert all(r["plane"] == "CPU" for r in rows)   # no card here
    table = pyprof.op_table(rows)
    assert "total ms" in table and rows[0]["name"][:20] in table
    assert pyprof.parse(_trace(tmp_path), plane_filter="GPU") == []


def test_parse_trace_trigger_capture(tmp_path):
    """A ``TraceTrigger`` window (``step<N>/trace.json``) parses as a
    ``trace`` capture does; two windows are two files."""
    from apex_tpu_torch.telemetry.spans import TraceTrigger

    x, w = _randn(64, 64), _randn(64, 64, seed=1)
    trig = TraceTrigger(trace_dir=str(tmp_path / "tt"), steps=2)
    for i in range(6):
        if i in (0, 3):
            open(trig.trigger_file, "w").close()
        _step(x, w)
        trig.poll(i)
    trig.close()
    assert trig.captures == 2
    rows = pyprof.parse(str(tmp_path / "tt"))
    mm = [r for r in rows if r["name"] == "aten::mm"]
    assert mm and sum(r["count"] for r in mm) >= 2
    assert len(pyprof.parse.__globals__["trace_files"](
        str(tmp_path / "tt"))) == 2


def test_parse_missing_or_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        pyprof.parse(str(tmp_path / "nope"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        pyprof.parse(str(tmp_path / "empty"))


#: HLO names of the JAX vocabulary (XLA opcodes, fusions, the Pallas
#: calls' names)
HLO_NAMES = (
    "%dot.12", "fusion.3", "while.2", "convert.9", "copy.2",
    "%copy-start.5 = (bf16[8,8,1024,128]{3,2,1,0}, u32[]{})",
    "all-reduce.1", "all-gather.2", "reduce-scatter.3", "all-to-all.4",
    "collective-permute.7", "convolution.4", "flash_attention_fwd",
    "threefry2x32", "mystery_kernel_xyz", "dynamic-slice.1",
    "dynamic-update-slice.2", "reduce.5", "scatter.6", "gather.7",
    "select-and-scatter.8", "transpose.9", "broadcast.10", "add.11",
    "multiply.12", "exponential.13", "rsqrt.14", "tanh.15", "compare.16",
    "select.17", "iota.18", "sort.19", "rng-bit-generator.20",
    "custom-call.21", "infeed.22", "outfeed.23", "send.24", "recv.25",
    "conditional.26", "cholesky.27", "pad.28", "concatenate.29",
    "bitcast.30", "reshape.31", "maximum.32", "log.33", "cumsum.34",
    "batch-norm-training.35", "call.36", "negate.37", "and.38")

#: the port's names on the card: launch counters, CUDA symbols, cuBLAS,
#: ATen, cuDNN, NCCL, copies and memsets
PORT_NAMES = {
    "ln_fwd": "normalization", "ln_bwd": "normalization",
    "ln_bwd_fold": "normalization",
    "void (anonymous namespace)::ln_fwd_kernel<__nv_bfloat16, float, 1, 0>"
    "(__nv_bfloat16 const*)": "normalization",
    "short_fwd": "flash_attention", "short_bwd_seg_drop": "flash_attention",
    "mid_fwd_bias_f16": "flash_attention", "mid_bwd": "flash_attention",
    "flash_fwd_seg": "flash_attention", "flash_bwd_dkv_drop":
    "flash_attention", "flash_bwd_dq_dbias": "flash_attention",
    "void attn::sm90::fwd_kernel<__nv_bfloat16, 128, 2, false, false, "
    "false, false>(CUtensorMap_st, CUtensorMap_st)": "flash_attention",
    "void attn::sm90::bwd_dkv_kernel<__nv_bfloat16, 128, 2>()":
    "flash_attention",
    "void attn_delta_kernel<__nv_bfloat16, 128>()": "flash_attention",
    "paged_decode": "flash_attention", "paged_decode_int8_f16":
    "flash_attention", "paged_decode_tree": "flash_attention",
    "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16>()":
    "flash_attention",
    "dequant_int8": "gemm", "dequant_int4_f16": "gemm",
    "void dequant_wgmma<__nv_bfloat16, 128, false>()": "gemm",
    "multi_tensor_adam": "elementwise", "multi_tensor_l2norm":
    "elementwise", "multi_tensor_scale": "elementwise",
    "void (anonymous namespace)::step_kernel<1, float, float, float, "
    "false>(Table<5>, StepArgs)": "elementwise",
    "softmax_fwd": "reduction", "dropout": "rng", "dropout_f16": "rng",
    "dropout_kernel": "rng", "gumbel_argmax": "rng", "gumbel_kernel": "rng",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN": "gemm",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm",
    "cutlass3x_sm90_tensorop_gemm_bf16_bf16_f32_bf16": "gemm",
    "aten::mm": "gemm", "aten::addmm": "gemm",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc":
    "convolution",
    "sm80_xmma_dgrad_implicit_gemm_indexed_bf16": "convolution",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<c10::BFloat16>>()": "elementwise",
    "void at::native::elementwise_kernel<128, 2>()": "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::MeanOps<float>>>()": "reduction",
    "Memcpy HtoD (Pageable -> Device)": "host_transfer",
    "Memcpy DtoH (Device -> Pinned)": "host_transfer",
    "Memcpy DtoD (Device -> Device)": "copy_layout",
    "Memset (Device)": "copy_layout",
    "ncclKernel_AllReduce_RING_LL_Sum_float": "all_reduce",
    "ncclDevKernel_AllGather_RING_LL": "all_gather",
}


@pytest.mark.parametrize("name", HLO_NAMES)
def test_classify_agrees_with_jax_on_its_names(name):
    assert pyprof.classify(name) == jprof.classify(name)


@pytest.mark.parametrize("name", sorted(PORT_NAMES))
def test_classify_files_the_port_kernels(name):
    cls, kind = pyprof.classify(name)
    assert cls == PORT_NAMES[name]
    assert kind == dict((c, k) for c, _, k in pyprof.OP_CLASSES)[cls]


def test_op_classes_keep_jax_names_kinds_and_order():
    assert [(c, k) for c, _, k in pyprof.OP_CLASSES] == [
        (c, k) for c, _, k in jprof.OP_CLASSES]


def test_prof_class_report(tmp_path):
    classes = pyprof.prof(pyprof.parse(_trace(tmp_path)))
    by_name = {r["op_class"]: r for r in classes}
    assert "gemm" in by_name and by_name["gemm"]["kind"] == "compute"
    for r in classes:
        assert r["count"] >= 1 and r["total_ms"] >= 0 and r["ops"]
        assert set(r) == {"op_class", "kind", "count", "ops", "total_ms",
                          "avg_ms", "pct"}
    assert abs(sum(r["pct"] for r in classes) - 100.0) < 1e-6
    table = pyprof.prof_table(classes)
    assert "time by kind" in table and "class" in table
    # the profiler's own span is an envelope
    assert not any("PyTorch Profiler" in n for r in classes
                   for n in r["ops"])


def test_trace_region_nesting(tmp_path):
    x = _randn(16, 16)
    for round_ in ("t1", "t2"):
        with pyprof.trace(str(tmp_path / round_)):
            with pyprof.trace_region("outer"):
                y = x @ x
                with pyprof.trace_region("inner"):
                    torch.tanh(y)
        names = {r["name"] for r in pyprof.parse(str(tmp_path / round_))}
        assert {"outer", "inner", "aten::tanh"} <= names


def test_utilization_report(tmp_path):
    steps = 4
    log_dir = _trace(tmp_path, steps=steps, n=256)
    classes = pyprof.prof(pyprof.parse(log_dir))
    x, w = _randn(256, 256), _randn(256, 256, seed=1)
    costs = pyprof.cost_analysis(_step, x, w)
    rep = pyprof.utilization(classes, costs, peak_flops=1e12, steps=steps)
    want_keys = set(jprof.utilization(
        [{"kind": "compute", "total_ms": 1.0}], {"flops": 1.0},
        peak_flops=1e12, steps=1))
    assert set(rep) == want_keys
    assert rep["flops"] == 2 * 256 ** 3
    assert rep["compute_ms"] > 0 and rep["achieved_flops_per_sec"] > 0
