"""Tensor parallelism's pieces in the port against the JAX package's.

- ``parallel_state``: rank ``r``'s coordinates on every axis are the
  position of device ``r`` in JAX's ``get_mesh().devices`` for five grids
  of 8 (host arithmetic, no process group), and the getters answer the
  one-process grid before ``initialize_model_parallel``.
- One spawned run a degree (2 and 4 ranks over gloo, ``file://``
  rendezvous under ``tmp_path``, :func:`apex_tpu_torch.testing.distributed
  .spawn`) computes every case of this file; each is held against JAX's
  ``shard_map`` over ``tp`` CPU devices with the vma check on: the four
  regions forward and backward (``copy_to``'s reduced cotangent), the
  column, row and embedding layers' outputs and gradients, the two-step
  and fused cross entropy with and without smoothing and bias, the
  finite consensus with one rank's gradient set to inf, ``broadcast_data``
  and the 1-D split/gather.

Tolerances: fp32 on both sides; values within 1e-5 relative and 1e-6
absolute (sums in another order), the regions' and consensus' results
exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import amp as jamp
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.tensor_parallel import cross_entropy as jce
from apex_tpu.transformer.tensor_parallel import layers as jlayers
from apex_tpu.transformer.tensor_parallel import mappings as jmap
from apex_tpu_torch.testing.distributed import spawn
from apex_tpu_torch.transformer import parallel_state as tps

torch.set_num_threads(1)  # the suite's parallel workers share the cores

TOL = dict(rtol=1e-5, atol=1e-6)
GRIDS = [  # (tp, pp, cp, data_parallel_ici_size_)
    (2, 1, 1, None), (4, 1, 1, None), (2, 2, 1, None), (2, 2, 2, None),
    (2, 1, 1, 2)]
N, H, V, OUT = 6, 8, 16, 16      # tokens, hidden, vocab, features
CE_CASES = [(s, b) for s in (0.0, 0.1) for b in (False, True)]


def inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(N, H), col_w=f(H, OUT), col_b=f(OUT), row_w=f(OUT, H),
        row_b=f(H), row_x=f(N, OUT), c_col=f(N, OUT), c_row=f(N, H),
        emb_w=f(V, H), ids=rng.randint(0, V, (N,)).astype(np.int32),
        c_emb=f(N, H), logits=f(N, V), targets=rng.randint(
            0, V, (N,)).astype(np.int32), ce_w=f(V, H), ce_b=f(V))


# ------------------------------------------------------------ the ranks

def _ranks(rank, inp):
    """Every case of this file on one rank (runs in a spawned process)."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer import utils as tutils
    from apex_tpu_torch.transformer.amp import (
        GradScaler, model_parallel_all_finite)
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
        broadcast_data, copy_to_tensor_model_parallel_region,
        gather_from_tensor_model_parallel_region, normal_init,
        reduce_from_tensor_model_parallel_region,
        scatter_to_tensor_model_parallel_region,
        vocab_parallel_cross_entropy, vocab_parallel_cross_entropy_from_hidden)
    from apex_tpu_torch.transformer.tensor_parallel.layers import shard

    tp = tps.get_tensor_model_parallel_world_size()
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    # the regions
    x = torch.arange(16.0).reshape(2, 8)
    chunk = scatter_to_tensor_model_parallel_region(x)
    out["scatter_shape"] = tuple(chunk.shape)
    out["roundtrip"] = gather_from_tensor_model_parallel_region(chunk)
    out["reduce"] = reduce_from_tensor_model_parallel_region(
        x * 0 + float(rank))
    xg = torch.ones(4, requires_grad=True)
    loss = reduce_from_tensor_model_parallel_region(
        (copy_to_tensor_model_parallel_region(xg) * float(rank)).sum())
    loss.backward()
    out["copy_grad"] = xg.grad
    xs = torch.arange(8.0, requires_grad=True)
    (scatter_to_tensor_model_parallel_region(xs) * (rank + 1.0)).sum() \
        .backward()
    out["scatter_grad"] = xs.grad
    xl = torch.ones(2, requires_grad=True)
    (gather_from_tensor_model_parallel_region(xl)
     * torch.arange(2.0 * tp)).sum().backward()
    out["gather_grad"] = xl.grad

    def layer_case(layer, params, x_in, c):
        with torch.no_grad():
            for name, full in params.items():
                getattr(layer, name).copy_(
                    shard(full, layer.param_specs()[name], tp, rank))
        x_in = x_in.clone().requires_grad_(x_in.is_floating_point())
        y = layer(x_in)
        (y * c).sum().backward()
        res = {"y": y.detach()}
        res.update({n: getattr(layer, n).grad for n in params})
        if x_in.requires_grad:
            res["dx"] = x_in.grad
        return res

    kw = dict(init_method=normal_init(), device="cpu")
    out["column"] = layer_case(
        ColumnParallelLinear(H, OUT, gather_output=True, **kw),
        {"weight": t["col_w"], "bias": t["col_b"]}, t["x"], t["c_col"])
    out["row"] = layer_case(
        RowParallelLinear(OUT, H, input_is_parallel=False, **kw),
        {"weight": t["row_w"], "bias": t["row_b"]}, t["row_x"], t["c_row"])
    out["embedding"] = layer_case(
        VocabParallelEmbedding(V, H, **kw), {"weight": t["emb_w"]},
        t["ids"], t["c_emb"])

    # the two cross entropy paths
    per = V // tp
    rows = slice(rank * per, (rank + 1) * per)
    for smoothing, with_bias in CE_CASES:
        logits = t["logits"][:, rows].clone().requires_grad_()
        loss = vocab_parallel_cross_entropy(logits, t["targets"],
                                            smoothing).mean()
        loss.backward()
        out[("two_step", smoothing)] = (loss.detach(), logits.grad)
        xh = t["x"].clone().requires_grad_()
        w = t["ce_w"][rows].clone().requires_grad_()
        b = t["ce_b"][rows].clone().requires_grad_() if with_bias else None
        loss = vocab_parallel_cross_entropy_from_hidden(
            xh, w, t["targets"], chunk=per // 2, bias=b,
            smoothing=smoothing).mean()
        loss.backward()
        out[("fused", smoothing, with_bias)] = (
            loss.detach(), xh.grad, w.grad, None if b is None else b.grad)

    # the finite consensus: rank 1's gradient holds an inf
    out["finite"] = (
        bool(model_parallel_all_finite(torch.tensor(rank != 1))),
        bool(model_parallel_all_finite(torch.tensor(True))))
    grads = [torch.ones(3), torch.full((2,), float("inf") if rank == 1
                                       else 1.0)]
    gs = GradScaler()
    _, fin = gs.unscale(gs.init("cpu"), grads)
    out["scaler_finite"] = bool(fin)
    # broadcast from tp rank 0, the 1-D split and gather
    got = broadcast_data({"a": torch.full((3,), float(rank)),
                          "b": [torch.tensor([rank], dtype=torch.int32)]})
    out["broadcast"] = (got["a"], got["b"][0])
    flat = torch.arange(24.0).reshape(2, 12)
    piece = tutils.split_tensor_into_1d_equal_chunks(flat)
    out["split"] = piece
    out["gather"] = tutils.gather_split_1d_tensor(piece)
    out["group"] = dist.get_world_size(tps.get_tensor_model_parallel_group())
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = inputs()
    return {tp: spawn(_ranks, tp, (inp,),
                      workdir=str(tmp_path_factory.mktemp(f"tp{tp}")))
            for tp in (2, 4)}


# -------------------------------------------------------- JAX reference

@pytest.fixture
def jax_mesh():
    meshes = []

    def make(tp):
        if jps.model_parallel_is_initialized():
            jps.destroy_model_parallel()
        meshes.append(jps.initialize_model_parallel(
            tensor_model_parallel_size_=tp, devices=jax.devices()[:tp]))
        return meshes[-1]

    yield make
    if jps.model_parallel_is_initialized():
        jps.destroy_model_parallel()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _cat(parts, spec):
    """The full tensor of the ranks' shards under a JAX spec."""
    parts = [_np(p) for p in parts]
    if "tp" not in tuple(spec):
        return parts[0]
    return np.concatenate(parts, axis=tuple(spec).index("tp"))


# ------------------------------------------------------------- the grid

@pytest.mark.parametrize("tp, pp, cp, ici", GRIDS,
                         ids=[f"tp{g[0]}-pp{g[1]}-cp{g[2]}-ici{g[3]}"
                              for g in GRIDS])
def test_rank_coordinates_are_jax_mesh_positions(jax_mesh, tp, pp, cp, ici):
    if jps.model_parallel_is_initialized():
        jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size_=tp, pipeline_model_parallel_size_=pp,
        context_parallel_size_=cp, data_parallel_ici_size_=ici,
        devices=jax.devices()[:8])
    grid = tps.rank_grid(8, tp, pp, cp, data_parallel_ici_size_=ici)
    assert grid.axis_names == tuple(mesh.axis_names)
    assert grid.shape == dict(mesh.shape)
    devices = jax.devices()[:8]
    for r in range(8):
        pos = np.argwhere(mesh.devices == devices[r])[0]
        assert grid.coords(r) == dict(zip(mesh.axis_names,
                                          (int(i) for i in pos)))
    for axis in grid.axis_names:
        for line in grid.lines(axis):
            others = [{a: c for a, c in grid.coords(r).items() if a != axis}
                      for r in line]
            assert all(o == others[0] for o in others)
            assert len(line) == dict(mesh.shape)[axis]


def test_grid_errors_and_getters_are_jax_s():
    with pytest.raises(RuntimeError, match="not divisible by tensor"):
        tps.rank_grid(8, 3)
    with pytest.raises(RuntimeError, match="data_parallel_ici_size_"):
        tps.rank_grid(8, 2, data_parallel_ici_size_=3)
    assert set(jps.__all__) <= set(tps.__all__)
    # before initialize_model_parallel: the one-process grid
    assert not tps.model_parallel_is_initialized()
    assert (tps.get_tensor_model_parallel_world_size(),
            tps.get_tensor_model_parallel_rank(),
            tps.get_data_parallel_world_size(),
            tps.get_pipeline_model_parallel_world_size()) == (1, 0, 1, 1)
    assert tps.get_tensor_model_parallel_group() is None
    with pytest.raises(RuntimeError, match="not initialized"):
        tps.get_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tps.initialize_model_parallel(2)


# ------------------------------------------------------ the regions

@pytest.mark.parametrize("tp", [2, 4])
def test_regions_forward_and_backward(ranks, tp):
    x = np.arange(16.0).reshape(2, 8)
    for r, out in enumerate(ranks[tp]):
        assert out["group"] == tp
        assert out["scatter_shape"] == (2, 8 // tp)
        np.testing.assert_array_equal(_np(out["roundtrip"]), x)
        np.testing.assert_array_equal(_np(out["reduce"]),
                                      np.full((2, 8), sum(range(tp))))
        # copy_to: d/dx sum_r sum(x * r) = sum_r r (JAX's test)
        np.testing.assert_array_equal(_np(out["copy_grad"]),
                                      np.full(4, sum(range(tp))))
        np.testing.assert_array_equal(
            _np(out["scatter_grad"]),
            np.repeat(np.arange(1.0, tp + 1), 8 // tp))
        np.testing.assert_array_equal(_np(out["gather_grad"]),
                                      np.arange(2.0 * r, 2.0 * r + 2))


def test_copy_region_backward_matches_jax(ranks, jax_mesh):
    for tp in (2, 4):
        mesh = jax_mesh(tp)

        def loss(x):
            xr = jmap.copy_to_tensor_model_parallel_region(x)
            rank = jax.lax.axis_index("tp").astype(jnp.float32)
            return jax.lax.psum(jnp.sum(xr * rank), "tp")

        g = jax.jit(jax.shard_map(jax.grad(loss), mesh=mesh,
                                  in_specs=(P(),), out_specs=P()))(
            jnp.ones((4,)))
        for out in ranks[tp]:
            np.testing.assert_array_equal(_np(out["copy_grad"]),
                                          np.asarray(g))


# ---------------------------------------------------------- the layers

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("which", ["column", "row", "embedding"])
def test_layers_match_jax(ranks, jax_mesh, tp, which):
    inp = inputs()
    mesh = jax_mesh(tp)
    if which == "column":
        layer = jlayers.ColumnParallelLinear(H, OUT, gather_output=True)
        params = {"weight": inp["col_w"], "bias": inp["col_b"]}
        x, c = inp["x"], inp["c_col"]
    elif which == "row":
        layer = jlayers.RowParallelLinear(OUT, H, input_is_parallel=False)
        params = {"weight": inp["row_w"], "bias": inp["row_b"]}
        x, c = inp["row_x"], inp["c_row"]
    else:
        layer = jlayers.VocabParallelEmbedding(V, H)
        params = {"weight": inp["emb_w"]}
        x, c = inp["ids"], inp["c_emb"]
    specs = layer.param_specs()
    floating = which != "embedding"

    def f(p, x):
        def loss(p, x):
            y = layer.apply(p, x)
            return jnp.sum(y * c), y
        argnums = (0, 1) if floating else 0
        (_, y), g = jax.value_and_grad(loss, argnums=argnums,
                                       has_aux=True)(p, x)
        return y, g

    out_g = (specs, P()) if floating else specs
    y, g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(specs, P()),
                                 out_specs=(P(), out_g)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = g if floating else (g, None)
    outs = [o[which] for o in ranks[tp]]
    for o in outs:
        np.testing.assert_allclose(_np(o["y"]), np.asarray(y), **TOL)
        if floating:
            np.testing.assert_allclose(_np(o["dx"]), np.asarray(gx), **TOL)
    for name, spec in specs.items():
        np.testing.assert_allclose(_cat([o[name] for o in outs], spec),
                                   np.asarray(gp[name]), **TOL,
                                   err_msg=name)


# -------------------------------------------------------- cross entropy

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("smoothing, with_bias", CE_CASES)
def test_cross_entropy_paths_match_jax(ranks, jax_mesh, tp, smoothing,
                                       with_bias):
    inp = inputs()
    mesh = jax_mesh(tp)
    t = jnp.asarray(inp["targets"])
    if not with_bias:   # the two-step path takes no bias
        def two(l):
            return jnp.mean(jce.vocab_parallel_cross_entropy(
                l, t, "tp", smoothing=smoothing))

        loss, g = jax.jit(jax.shard_map(
            jax.value_and_grad(two), mesh=mesh, in_specs=(P(None, "tp"),),
            out_specs=(P(), P(None, "tp"))))(jnp.asarray(inp["logits"]))
        outs = [o[("two_step", smoothing)] for o in ranks[tp]]
        for o in outs:
            np.testing.assert_allclose(_np(o[0]), np.asarray(loss), **TOL)
        np.testing.assert_allclose(_cat([o[1] for o in outs],
                                        P(None, "tp")), np.asarray(g), **TOL)

    per = V // tp
    args = [jnp.asarray(inp["x"]), jnp.asarray(inp["ce_w"])]
    specs = [P(), P("tp", None)]
    if with_bias:
        args.append(jnp.asarray(inp["ce_b"]))
        specs.append(P("tp"))

    def fused(x, w, b=None):
        return jnp.mean(jce.vocab_parallel_cross_entropy_from_hidden(
            x, w, t, "tp", chunk=per // 2, bias=b, smoothing=smoothing))

    loss, g = jax.jit(jax.shard_map(
        jax.value_and_grad(fused, argnums=tuple(range(len(args)))),
        mesh=mesh, in_specs=tuple(specs),
        out_specs=(P(), tuple(specs))))(*args)
    outs = [o[("fused", smoothing, with_bias)] for o in ranks[tp]]
    for o in outs:
        np.testing.assert_allclose(_np(o[0]), np.asarray(loss), **TOL)
        np.testing.assert_allclose(_np(o[1]), np.asarray(g[0]), **TOL)
    for i, spec in enumerate(specs[1:], start=1):
        np.testing.assert_allclose(_cat([o[i + 1] for o in outs], spec),
                                   np.asarray(g[i]), **TOL)


# --------------------------------------- consensus, broadcast, 1-D split

@pytest.mark.parametrize("tp", [2, 4])
def test_finite_consensus_matches_jax(ranks, jax_mesh, tp):
    mesh = jax_mesh(tp)

    def flags():
        rank = jax.lax.axis_index("tp")
        return (jamp.model_parallel_all_finite(rank != 1),
                jamp.model_parallel_all_finite(rank >= 0))

    want = jax.jit(jax.shard_map(flags, mesh=mesh, in_specs=(),
                                 out_specs=(P(), P())))()
    for out in ranks[tp]:
        assert out["finite"] == tuple(bool(w) for w in want) == (False, True)
        assert out["scaler_finite"] is False


@pytest.mark.parametrize("tp", [2, 4])
def test_broadcast_and_1d_split_gather(ranks, tp):
    flat = np.arange(24.0)
    for r, out in enumerate(ranks[tp]):
        np.testing.assert_array_equal(_np(out["broadcast"][0]),
                                      np.zeros(3))
        assert _np(out["broadcast"][1]).tolist() == [0]
        np.testing.assert_array_equal(
            _np(out["split"]), flat.reshape(tp, -1)[r])
        np.testing.assert_array_equal(_np(out["gather"]), flat)


def test_memory_buffers_are_jax_s():
    from apex_tpu.transformer.tensor_parallel import memory as jmem
    from apex_tpu_torch.transformer.tensor_parallel import memory as tmem

    for mod in (jmem, tmem):
        buf = mod.GlobalMemoryBuffer()
        a = buf.get_tensor((2, 3), np.float32, "x")
        assert buf.get_tensor((2, 3), np.float32, "x") is a
        assert buf.get_tensor((2, 3), np.float16, "x") is not a
        ring = mod.RingMemBuffer("r", 2, (4,), np.int32)
        first = ring.get_next_buffer()
        assert ring.get_next_buffer() is not first
        assert ring.get_next_buffer() is first
    assert os.path.basename(tmem.__file__) == "memory.py"
