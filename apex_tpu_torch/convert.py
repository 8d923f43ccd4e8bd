"""Carry GPT, BERT, T5 and ResNet weights and optimizer state between the
JAX package and the port.

The JAX ``GPTModel`` keeps its parameters as a nested dict with every
layer leaf STACKED on a leading ``num_layers`` dim
(``{"embedding": {"weight"}, "pos_embedding", "final_ln": {"scale",
"bias"}, "layers": {"ln1": ..., "qkv": {"weight", "bias"}, ...}}``).  The
port's ``GPTModel`` is an ``nn.Module`` with a ``ModuleList`` of layers,
so its state dict names ``layers.<i>.qkv.weight`` and so on.  The
Llama-mode tree (rope, RMSNorm, SwiGLU) has no ``pos_embedding``, norms
with a ``scale`` and no ``bias``, and a ``fc_gate`` per layer; so has
the port's model in that mode, and the bridge needs nothing else for
it.  Nor for BERT: its tree adds ``tokentype_embedding``,
``lm_head.{dense.{weight, bias}, ln.{scale, bias}, bias}``, ``pooler`` and
``binary_head``, which the port's ``BertModel`` names alike.  Nor for
contrib attention: a ``SelfMultiheadAttn``/``EncdecMultiheadAttn`` tree is
flat (``qkv_weight``, ``out_bias``, ``lyr_nrm.scale``, ...), and the port's
modules name their parameters alike.  T5's tree has two stacks,
``enc_layers`` and ``dec_layers``, which unstack as the GPT's ``layers``
(``enc_layers.<i>.cross_kv.weight``).  A ResNet crosses as two trees,
``params`` (``conv_stem``, ``bn_stem``, ``stages`` a list of stages each
a list of blocks, ``fc``) and ``batch_stats`` (``mean`` and ``var`` of
each norm): :func:`resnet_from_jax` makes one state dict of both, list
indices as names (``stages.1.0.conv_proj``, ``stages.1.0.bn1.mean``), and
:func:`resnet_to_jax` splits it again; conv weights stay HWIO.  All keep
the same per-leaf layouts (linear weights ``(in, out)``, the qkv output
grouped per head, the LM head tied to ``embedding.weight``), so the
bridge only flattens/unstacks the tree: values are copied bit for bit
and a round trip is exact.

A quantized serving tree (JAX ``quantize_gpt_weights``: each projection
leaf ``{"q8" | "q4", "scales", "bias"}``, int8 values or packed int4
bytes beside fp32 scales) crosses the same way, to and from the buffers
of the port's ``QuantizedLinear`` (``layers.<i>.qkv.q8``,
``layers.<i>.qkv.scales``, ...): load it into a model that
``apex_tpu_torch.models.gpt.quantize_gpt_weights`` converted with the same
width and block, strictly.

Takes and returns numpy arrays (``jax.tree.map(np.asarray, params)`` on
the JAX side), so neither package imports the other.  bf16 leaves (O5)
are ``ml_dtypes.bfloat16`` arrays in numpy, which ``torch.from_numpy``
rejects: they cross as their 16-bit patterns, so they too are copied bit
for bit (``ml_dtypes``, which JAX installs, is imported only to hand a
bf16 tensor back).  fp16 leaves (the O1-O3 trees: fp16 weights, fp32 norms
at O2) are numpy's own float16 and cross as they are, bit for bit, as do
the fp32 masters of their optimizer state.

The optimizer state of the fused optimizers (``{"step", "exp_avg",
"exp_avg_sq", "master"}``, each moment and master a tree shaped like the
params, or with ``fused_tail=True`` a dict of packed buckets
``bucket_000``, ...) goes both ways with :func:`optimizer_state_from_jax`
and :func:`optimizer_state_to_jax`: the JAX step becomes the port's one
device counter, and a packed JAX state is unpacked with the plan of the
JAX tree (rebuilt from the model's own parameters) and packed again in
the port optimizer's layout, so a JAX step and a port step can start from
one state.  The loss scaler's state crosses with
:func:`scaler_state_from_jax` and :func:`scaler_state_to_jax`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "resnet_from_jax",
           "resnet_to_jax", "optimizer_state_from_jax",
           "optimizer_state_to_jax", "scaler_state_from_jax",
           "scaler_state_to_jax"]

#: the per-parameter trees of a FusedAdam state, besides ``step``
OPT_STATE_TREES = ("exp_avg", "exp_avg_sq", "master")


#: the tree keys whose leaves are stacked on a leading layer dim (the
#: GPT's and BERT's ``layers``, T5's two stacks)
STACKED = ("layers", "enc_layers", "dec_layers")


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, prefix + (str(i),))
    else:
        yield prefix, tree


def _listify(node: Any) -> Any:
    """Dicts keyed ``"0".."n-1"`` (ResNet's stages and blocks) back into
    lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(int(k) for k in node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} are not "
                             f"0..{len(node) - 1}")
        return [node[str(i)] for i in range(len(node))]
    return node


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``arr``'s values (bf16 through its bit pattern)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array (bf16 as ``ml_dtypes.bfloat16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        from ml_dtypes import bfloat16

        return t.view(torch.int16).numpy().view(bfloat16)
    return t.numpy()


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX GPT, BERT, T5 or ResNet parameter tree (numpy leaves) -> the
    port's state dict (CPU tensors; ``load_state_dict`` moves them).  A
    stacked layer leaf (:data:`STACKED`) becomes one entry a layer, a
    list entry (ResNet's ``stages``) one entry an index.  ResNet's
    ``batch_stats`` tree crosses the same way (:func:`resnet_from_jax`
    takes both)."""
    state: Dict[str, torch.Tensor] = {}
    for key, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if key[0] in STACKED:
            for i in range(arr.shape[0]):
                state[".".join((key[0], str(i)) + key[1:])] = \
                    _tensor(arr[i])
        else:
            state[".".join(key)] = _tensor(arr)
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> the JAX GPT, BERT, T5 or ResNet parameter
    tree (numpy leaves, each stack's layer leaves stacked on a leading
    dim, ResNet's stages and blocks as lists)."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, t in state.items():
        arr = _array(t)
        parts = name.split(".")
        if parts[0] in STACKED:
            per_layer.setdefault((parts[0],) + tuple(parts[2:]), {})[
                int(parts[1])] = arr
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    tree = _listify(tree)
    for key, by_index in per_layer.items():
        if sorted(by_index) != list(range(len(by_index))):
            raise ValueError(f"layer indices of {'.'.join(key)} are not "
                             f"0..{len(by_index) - 1}")
        node = tree
        for p in key[:-1]:
            node = node.setdefault(p, {})
        node[key[-1]] = np.stack([by_index[i]
                                  for i in range(len(by_index))])
    return tree


#: the leaves of a ResNet state dict that are running statistics
STAT_LEAVES = ("mean", "var")


def resnet_from_jax(params: Dict[str, Any],
                    batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ResNet's ``(params, batch_stats)`` -> the port's state dict:
    the parameters (HWIO conv weights as they are) and the running
    statistics' buffers (``bn_stem.mean``, ``stages.0.0.bn1.var``, ...)."""
    state = params_from_jax(params)
    state.update(params_from_jax(batch_stats))
    return state


def resnet_to_jax(state: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The port's ResNet state dict -> the JAX ``(params, batch_stats)``
    trees."""
    stats = {k: v for k, v in state.items()
             if k.rsplit(".", 1)[-1] in STAT_LEAVES}
    params = {k: v for k, v in state.items() if k not in stats}
    return params_to_jax(params), params_to_jax(stats)


def _is_packed(tree: Any) -> bool:
    return isinstance(tree, dict) and bool(tree) and all(
        str(k).startswith("bucket_") for k in tree)


def _jax_plan(model: torch.nn.Module, bucket_bytes: int):
    """The fused tail's plan over the JAX tree of ``model``'s parameters
    (leaves in JAX's sorted flatten order, layers stacked), and those
    leaves as ``(key, array)``."""
    from apex_tpu_torch.optimizers.fused_tail import tail_plan

    leaves = list(_flatten(params_to_jax(model.state_dict())))
    return tail_plan([np.shape(a) for _, a in leaves], bucket_bytes), leaves


def _bucket_bytes(optimizer) -> int:
    from apex_tpu_torch.optimizers.fused_tail import DEFAULT_BUCKET_BYTES

    return getattr(optimizer, "bucket_bytes", None) or DEFAULT_BUCKET_BYTES


def _unpack_jax(packed: Dict[str, Any], model, optimizer) -> Dict[str, Any]:
    """A packed JAX state tree (``{bucket_000: flat, ...}``) as the
    per-leaf JAX tree of the model's parameters."""
    plan, leaves = _jax_plan(model, _bucket_bytes(optimizer))
    if sorted(packed) != plan.names or any(
            np.asarray(packed[n]).size != b.size
            for n, b in zip(plan.names, plan.buckets)):
        raise ValueError(
            "the packed state's buckets are not the plan of this model at "
            f"bucket_bytes={_bucket_bytes(optimizer)}: got "
            f"{[(n, np.asarray(packed[n]).size) for n in sorted(packed)]}")
    tree: Dict[str, Any] = {}
    for b, name in zip(plan.buckets, plan.names):
        buf, off = np.asarray(packed[name]), 0
        for i, size in zip(b.leaf_ids, b.sizes):
            key, like = leaves[i]
            node = tree
            for part in key[:-1]:
                node = node.setdefault(part, {})
            node[key[-1]] = buf[off:off + size].reshape(np.shape(like))
            off += size
    return tree


def optimizer_state_from_jax(opt_state: Dict[str, Any], model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> None:
    """Load a JAX fused-optimizer state (numpy leaves; per-leaf trees or
    the fused tail's packed buckets) into ``optimizer``'s state for
    ``model``'s parameters, on their devices, in the optimizer's own
    layout (per-leaf, or packed with ``fused_tail``)."""
    step = int(np.asarray(opt_state["step"]))
    trees = {}
    for key in OPT_STATE_TREES:
        if key not in opt_state:
            continue
        tree = opt_state[key]
        if _is_packed(tree):
            tree = _unpack_jax(tree, model, optimizer)
        trees[key] = params_from_jax(tree)
    for name, p in model.named_parameters():
        state = {"step": torch.tensor(step, dtype=torch.int32)}
        for key, tensors in trees.items():
            state[key] = tensors[name].to(p.device)
        optimizer.state[p] = state
    relink = getattr(optimizer, "_relink", None)
    if relink is not None:
        relink()


def optimizer_state_to_jax(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer``'s state for ``model`` as a JAX fused-optimizer state
    (numpy leaves, layer leaves stacked; with ``fused_tail`` the packed
    buckets of the JAX tree's plan)."""
    named = list(model.named_parameters())
    states = [optimizer.state[p] for _, p in named]
    steps = {int(s["step"]) for s in states}
    if len(steps) != 1:
        raise ValueError(f"parameters are at different steps {sorted(steps)}")
    out: Dict[str, Any] = {"step": np.int32(steps.pop())}
    packed = bool(getattr(optimizer, "fused_tail", False))
    if packed:
        plan, leaves = _jax_plan(model, _bucket_bytes(optimizer))
    for key in OPT_STATE_TREES:
        if key not in states[0]:
            continue
        tree = params_to_jax({name: s[key] for (name, _), s
                              in zip(named, states)})
        if packed:
            flat = dict(_flatten(tree))
            tree = {name: np.concatenate(
                        [np.asarray(flat[leaves[i][0]]).reshape(-1)
                         for i in b.leaf_ids])
                    for b, name in zip(plan.buckets, plan.names)}
        out[key] = tree
    return out


def scaler_state_from_jax(state: Any, device=None):
    """A JAX ``ScalerState`` (or its numpy fields) as the port's
    :class:`~apex_tpu_torch.amp.scaler.ScalerState` on ``device`` (the GPU
    by default)."""
    from apex_tpu_torch.amp.scaler import ScalerState
    from apex_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    return ScalerState(
        torch.tensor(np.asarray(fields["loss_scale"]), dtype=torch.float32,
                     device=dev).reshape(()),
        torch.tensor(np.asarray(fields["growth_tracker"]),
                     dtype=torch.int32, device=dev).reshape(()),
        torch.tensor(np.asarray(fields["unskipped"]), dtype=torch.int32,
                     device=dev).reshape(()))


def scaler_state_to_jax(state: Any) -> Dict[str, np.ndarray]:
    """The port's scaler state as numpy fields of a JAX ``ScalerState``
    (``ScalerState(**fields)`` on the JAX side)."""
    return {"loss_scale": np.float32(state.loss_scale.item()),
            "growth_tracker": np.int32(state.growth_tracker.item()),
            "unskipped": np.int32(state.unskipped.item())}
