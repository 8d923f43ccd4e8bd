"""Carry GPT and BERT weights and optimizer state between the JAX package
and the port.

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
modules name their parameters alike.  Both keep
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
bf16 tensor back).

The optimizer state of ``FusedAdam`` (``{"step", "exp_avg",
"exp_avg_sq", "master"}``, each moment and master a tree shaped like the
params) goes both ways with :func:`optimizer_state_from_jax` and
:func:`optimizer_state_to_jax`, so a JAX step and a port step can start
from one state.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "optimizer_state_from_jax",
           "optimizer_state_to_jax"]

#: the per-parameter trees of a FusedAdam state, besides ``step``
OPT_STATE_TREES = ("exp_avg", "exp_avg_sq", "master")


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


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
    """JAX GPT or BERT parameter tree (numpy leaves) -> the port's state
    dict (CPU tensors; ``load_state_dict`` moves them)."""
    state: Dict[str, torch.Tensor] = {}
    for key, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if key[0] == "layers":
            for i in range(arr.shape[0]):
                state[".".join(("layers", str(i)) + key[1:])] = \
                    _tensor(arr[i])
        else:
            state[".".join(key)] = _tensor(arr)
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> the JAX GPT or BERT parameter tree (numpy
    leaves, layer leaves stacked on a leading ``num_layers`` dim)."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, t in state.items():
        arr = _array(t)
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(tuple(parts[2:]), {})[int(parts[1])] = arr
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    layers: Dict[str, Any] = {}
    for key, by_index in per_layer.items():
        if sorted(by_index) != list(range(len(by_index))):
            raise ValueError(f"layer indices of {'.'.join(key)} are not "
                             f"0..{len(by_index) - 1}")
        node = layers
        for p in key[:-1]:
            node = node.setdefault(p, {})
        node[key[-1]] = np.stack([by_index[i]
                                  for i in range(len(by_index))])
    if layers:
        tree["layers"] = layers
    return tree


def optimizer_state_from_jax(opt_state: Dict[str, Any], model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> None:
    """Load a JAX FusedAdam state (numpy leaves) into ``optimizer``'s
    per-parameter state for ``model``'s parameters, on their devices."""
    step = int(np.asarray(opt_state["step"]))
    trees = {key: params_from_jax(opt_state[key])
             for key in OPT_STATE_TREES if key in opt_state}
    for name, p in model.named_parameters():
        state = {"step": step}
        for key, tensors in trees.items():
            state[key] = tensors[name].to(p.device)
        optimizer.state[p] = state


def optimizer_state_to_jax(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer``'s per-parameter state for ``model`` as a JAX
    FusedAdam state (numpy leaves, layer leaves stacked)."""
    named = list(model.named_parameters())
    states = [optimizer.state[p] for _, p in named]
    steps = {int(s["step"]) for s in states}
    if len(steps) != 1:
        raise ValueError(f"parameters are at different steps {sorted(steps)}")
    out: Dict[str, Any] = {"step": np.int32(steps.pop())}
    for key in OPT_STATE_TREES:
        if key in states[0]:
            out[key] = params_to_jax({name: s[key] for (name, _), s
                                      in zip(named, states)})
    return out
