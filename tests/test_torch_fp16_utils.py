"""The port's ``fp16_utils`` against the JAX package's
(``apex_tpu.fp16_utils``), on the same numpy trees and gradients.

The casts are exact, so the trees agree leaf for leaf, dtypes and bits.
``FP16_Optimizer`` runs 4 steps in both packages with dynamic loss
scaling from the same fp16 parameters and the same scaled fp16 gradients,
the third step's gradients holding an inf: the loss-scale trajectory and
the skipped step are the same, the fp32 masters agree to 1e-6 relative
(the same Adam arithmetic in fp32, JAX's through XLA), and the fp16
parameters, each the master rounded once, to one fp16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fp16_utils as jfp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import fp16_utils as tfp
from apex_tpu_torch.optimizers import FusedAdam

LR = 1e-2


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"dense": {"weight": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)},
            "ln": {"scale": rng.randn(3).astype(np.float32)},
            "ids": np.arange(3, dtype=np.int32)}


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _same(port, jax_tree):
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), port)))
    assert flat_j.keys() == flat_t.keys()
    for path, leaf in flat_j.items():
        leaf = np.asarray(leaf)
        assert flat_t[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_t[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_network_casts_match_jax(dtype):
    jdt = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}[dtype]
    tree = _tree()
    if dtype == torch.bfloat16:
        # numpy holds no bf16 the port's tensors could be compared in
        got = tfp.network_to_half(_torch_tree(tree), dtype)
        assert got["dense"]["weight"].dtype == torch.bfloat16
        assert got["ids"].dtype == torch.int32
        return
    _same(tfp.network_to_half(_torch_tree(tree), dtype),
          jfp.network_to_half(jax.tree.map(jnp.asarray, tree), jdt))
    _same(tfp.convert_network(_torch_tree(tree), dtype),
          jfp.convert_network(jax.tree.map(jnp.asarray, tree), jdt))


def test_convert_network_keeps_a_modules_norms_fp32():
    m = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.LayerNorm(4),
                            torch.nn.BatchNorm1d(4))
    tfp.convert_network(m)
    assert m[0].weight.dtype == torch.float16
    assert m[1].weight.dtype == m[2].weight.dtype == torch.float32
    assert m[2].running_mean.dtype == torch.float32
    tfp.network_to_half(m)
    assert all(p.dtype == torch.float16 for p in m.parameters())


def test_param_lists_and_grad_copies_match_jax():
    tree = jax.tree.map(lambda x: x.astype(np.float16),
                        {k: v for k, v in _tree(1).items() if k != "ids"})
    jp, jm = jfp.prep_param_lists(jax.tree.map(jnp.asarray, tree))
    tp, tm = tfp.prep_param_lists(_torch_tree(tree))
    _same(tm, jm)
    _same(tfp.model_grads_to_master_grads(tp),
          jfp.model_grads_to_master_grads(jp))
    back = jax.tree.map(lambda m: m * 3, jm)
    _same(tfp.master_params_to_model_params(
        tp, jax.tree.map(lambda m: m * 3, tm)),
        jfp.master_params_to_model_params(jp, back))


def test_fp16_optimizer_matches_jax_with_an_overflow():
    rng = np.random.RandomState(3)
    shapes = [(8, 5), (5,), (5, 3)]
    params = [rng.randn(*s).astype(np.float16) for s in shapes]
    grads = [[(rng.randn(*s) * 1e-3).astype(np.float32) for s in shapes]
             for _ in range(4)]
    grads[2][1][2] = np.inf
    jopt = jfp.FP16_Optimizer(JaxFusedAdam(lr=LR), dynamic_loss_scale=True)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    tparams = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    topt = tfp.FP16_Optimizer(FusedAdam(tparams, lr=LR),
                              dynamic_loss_scale=True)
    jscales, tscales, jfin, tfin = [], [], [], []
    for step in grads:
        scale = float(jstate["scaler"].loss_scale)
        assert scale == float(topt.loss_scale)
        # the scaled fp16 gradients a backward of the scaled loss leaves
        scaled = [(g * scale).astype(np.float16) for g in step]
        jfin.append(all(np.isfinite(g).all() for g in scaled))
        jparams, jstate = jopt.step(jstate, [jnp.asarray(g) for g in scaled],
                                    jparams)
        for p, g in zip(tparams, scaled):
            p.grad = torch.from_numpy(g)
        tfin.append(bool(topt.step()))
        jscales.append(float(jstate["scaler"].loss_scale))
        tscales.append(float(topt.loss_scale))
    assert tfin == jfin == [True, True, False, True]
    assert tscales == jscales and tscales[2] == tscales[1] / 2
    for tm, jm in zip(topt.master_params, jstate["master"]):
        np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm),
                                   rtol=1e-6, atol=1e-7)
    for tp, jp in zip(tparams, jparams):
        jp = np.asarray(jp).astype(np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jp), 2.0 ** -14)))
                      - 10)
        assert tp.dtype == torch.float16
        assert (np.abs(tp.detach().float().numpy() - jp) <= ulp).all()


def test_fp16_optimizer_state_round_trip_and_clip():
    p = torch.randn(6, dtype=torch.float16).requires_grad_()
    opt = tfp.FP16_Optimizer(FusedAdam([p], lr=LR), static_loss_scale=4.0)
    p.grad = torch.full((6,), 8.0, dtype=torch.float16)
    assert bool(opt.step())
    saved = opt.state_dict()
    assert saved["scaler"]["loss_scale"] == 4.0
    q = p.detach().clone().requires_grad_()
    other = tfp.FP16_Optimizer(FusedAdam([q], lr=LR), static_loss_scale=4.0)
    other.load_state_dict(saved)
    assert torch.equal(other.master_params[0], opt.master_params[0])
    assert torch.equal(q, p)
    g = [torch.full((4,), 3.0), torch.full((9,), 4.0)]
    clipped = opt.clip_master_grads(g, 1.0)
    norm = torch.sqrt(sum((c ** 2).sum() for c in clipped))
    assert abs(norm.item() - 1.0) < 1e-6
    with pytest.raises(ValueError, match="masters"):
        tfp.FP16_Optimizer(FusedAdam([q], lr=LR, master_weights=True))
