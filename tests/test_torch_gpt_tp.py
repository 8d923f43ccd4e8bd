"""The port's GPT trained at tensor-parallel degree 2 and 4 against the JAX
package's ``shard_map`` over as many CPU devices, with the vma check ON
(with it off JAX's gradients at tp > 1 are wrong: psum's transpose
changes).

One numpy-drawn tree (std 0.2) feeds both: each spawned rank (gloo,
:func:`apex_tpu_torch.testing.distributed.spawn`, one run a degree for
every case) loads its shards through ``convert.params_from_jax(tree,
tp=, rank=)`` and runs ``loss``, its backward (remat on, so the
recompute re-issues the forward's collectives) and ``clip_grad_norm``;
the ranks' gradients joined by ``convert.unshard_state`` are held to
JAX's ``value_and_grad(loss)`` and its ``clip_grad_norm`` norm, for the
learned and the Llama mode (rope, RMSNorm, SwiGLU) through the two-step
and the fused cross entropy, and at tp=2 with attention and hidden
dropout from one key (JAX's masks at tp=2: the attention seed differs
per rank, the hidden key does not).  Also: the ranks' state dicts
gathered back by ``params_to_jax`` are the tree bit for bit, a model
built from a seed at tp holds the shards of the tp=1 model of that seed,
and the trainer's ``--tp 2`` gives the losses of ``--tp 1``.

Tolerances: fp32, the loss within 1e-5, every gradient and the norm
within ``rtol=2e-4`` (``tests/test_gpt.py``'s band for tp invariance),
``atol=2e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.tensor_parallel.utils import (
    clip_grad_norm as jax_clip)
from apex_tpu_torch import convert
from apex_tpu_torch.examples import gpt_pretrain
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.testing.distributed import spawn
from apex_tpu_torch.transformer import parallel_state as tps

torch.set_num_threads(1)  # the suite's parallel workers share the cores

SIZES = dict(vocab_size=64, num_layers=2, hidden_size=32,
             num_attention_heads=4, max_position_embeddings=64,
             fused_ce_chunk=8)
LLAMA = dict(position_embedding="rope", activation="swiglu",
             normalization="rmsnorm")
DROP = dict(hidden_dropout=0.1, attention_dropout=0.1)
#: case -> (config fields, dropout key seed or None, degrees)
CASES = {
    "learned": (dict(fused_ce=False), None, (2, 4)),
    "llama": (dict(LLAMA, fused_ce=False), None, (2,)),
    "learned-fused": (dict(fused_ce=True), None, (2,)),
    "llama-fused": (dict(LLAMA, fused_ce=True), None, (2, 4)),
    "dropout": (dict(DROP, fused_ce=False), 5, (2,)),
}
CLIP = 1e-3
TRAIN = ["--layers", "2", "--hidden", "32", "--heads", "4", "--vocab", "64",
         "--seq", "12", "--micro-batch", "2", "--num-micro", "1",
         "--steps", "3", "--lr", "1e-2", "--opt-level", "O0",
         "--clip-grad", "0.5", "--device", "cpu", "--log-every", "1"]


def tree(case):
    jm = JaxGPTModel(JaxGPTConfig(**SIZES, **CASES[case][0],
                                  compute_dtype=jnp.float32, remat=False))
    rng = np.random.RandomState(len(case))
    params = jax.tree.map(
        lambda x: (0.2 * rng.randn(*x.shape)).astype(np.float32),
        jm.init(jax.random.PRNGKey(0)))
    return jm, params


def batch(seed=1):
    toks = np.random.RandomState(seed).randint(0, 64, (2, 12)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _key(seed):
    return None if seed is None else np.asarray(jax.random.PRNGKey(seed))


# ------------------------------------------------------------ the ranks

def _ranks(rank, trees, toks, tgts):
    """Every case of this file on one rank (a spawned process)."""
    from apex_tpu_torch.transformer.tensor_parallel import clip_grad_norm

    tp = tps.get_tensor_model_parallel_world_size()
    out = {}
    for case, (fields, seed, degrees) in CASES.items():
        if tp not in degrees:
            continue
        tm = GPTModel(GPTConfig(**SIZES, **fields,
                                compute_dtype=torch.float32),
                      device="cpu")
        tm.load_state_dict(convert.params_from_jax(trees[case], tp, rank))
        rng = None if seed is None else trees["keys"][seed]
        loss = tm.loss(torch.from_numpy(toks), torch.from_numpy(tgts),
                       rng=rng)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
        norm = clip_grad_norm(tm.parameters(), CLIP)
        out[case] = (loss.item(), grads, norm.item(), tm.state_dict())
    # a model drawn from a seed holds the shards of that seed's tp=1 model
    out["seeded"] = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                             device="cpu", seed=3).state_dict()
    if tp == 2:
        out["train"] = gpt_pretrain.main(TRAIN + ["--tp", "2"])["losses"]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    trees = {case: tree(case)[1] for case in CASES}
    trees["keys"] = {5: _key(5)}
    toks, tgts = batch()
    return {tp: spawn(_ranks, tp, (trees, toks, tgts),
                      workdir=str(tmp_path_factory.mktemp(f"tp{tp}")))
            for tp in (2, 4)}


def jax_reference(case, tp):
    """``(loss, grads (the port's names), clip norm)`` from JAX at
    ``tp`` with the vma check on."""
    jm, params = tree(case)
    if jps.model_parallel_is_initialized():
        jps.destroy_model_parallel()
    mesh = jps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                         devices=jax.devices()[:tp])
    try:
        specs = jm.param_specs()
        key = CASES[case][1]
        rng = None if key is None else jax.random.PRNGKey(key)
        toks, tgts = batch()

        def step(p, t, y):
            loss, g = jax.value_and_grad(jm.loss)(p, t, y, rng)
            _, norm = jax_clip(g, specs, CLIP)
            return loss, g, norm

        loss, g, norm = jax.jit(jax.shard_map(
            step, mesh=mesh, in_specs=(specs, P("dp"), P("dp")),
            out_specs=(P(), specs, P())))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(toks),
            jnp.asarray(tgts))
    finally:
        jps.destroy_model_parallel()
    return (float(loss), convert.params_from_jax(jax.tree.map(np.asarray, g)),
            float(norm))


CASE_IDS = [(case, tp) for case, (_, _, degrees) in CASES.items()
            for tp in degrees]


@pytest.mark.parametrize("case, tp", CASE_IDS,
                         ids=[f"{c}-tp{t}" for c, t in CASE_IDS])
def test_loss_grads_and_clip_norm_match_jax(ranks, case, tp):
    want_loss, want_g, want_norm = jax_reference(case, tp)
    outs = [o[case] for o in ranks[tp]]
    for loss, _, norm, _ in outs:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(norm, want_norm, rtol=2e-4)
    grads = convert.unshard_state([o[1] for o in outs])
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=name)
    # a shard of each sharded leaf, the whole of each other one
    local = outs[0][1]
    assert local["embedding.weight"].shape[0] == 64 // tp
    assert local["layers.0.qkv.weight"].shape[1] == 96 // tp
    assert local["layers.0.attn_proj.weight"].shape[0] == 32 // tp
    assert local["layers.0.ln1.scale"].shape == (32,)
    if case == "dropout":
        # dropout really ran: the loss is not the one without a key
        plain = jax_reference("learned", tp)[0]
        assert abs(outs[0][0] - plain) > 1e-4


@pytest.mark.parametrize("tp", [2, 4])
def test_state_round_trip_and_seeded_shards(ranks, tp):
    case = "learned" if tp == 2 else "llama-fused"
    _, params = tree(case)
    back = convert.params_to_jax([o[case][3] for o in ranks[tp]])
    flat_want = dict(convert._flatten(params))
    flat_got = dict(convert._flatten(back))
    assert set(flat_got) == set(flat_want)
    for key, arr in flat_want.items():
        assert np.asarray(flat_got[key]).tobytes() == arr.tobytes(), key
    whole = GPTModel(GPTConfig(**SIZES, compute_dtype=torch.float32),
                     device="cpu", seed=3).state_dict()
    joined = convert.unshard_state([o["seeded"] for o in ranks[tp]])
    assert set(joined) == set(whole)
    for name, t in whole.items():
        assert torch.equal(joined[name], t), name


def test_trainer_at_tp2_gives_the_tp1_losses(ranks):
    want = gpt_pretrain.main(TRAIN)["losses"]
    for out in ranks[2]:
        np.testing.assert_allclose(out["train"], want, rtol=1e-5, atol=1e-6)
    assert len(want) == 3 and np.all(np.isfinite(want))


def test_trainer_tp_flags_raise_as_jax():
    with pytest.raises(ValueError, match="--fused-opt-tail needs"):
        gpt_pretrain.main(TRAIN + ["--tp", "2", "--fused-opt-tail"])
    with pytest.raises(NotImplementedError, match="9a remainder"):
        gpt_pretrain.main(TRAIN + ["--tp", "2", "--checkpoint-dir", "ck"])
    assert not tps.model_parallel_is_initialized()
