"""Carry GPT weights between the JAX package and the port.

The JAX ``GPTModel`` keeps its parameters as a nested dict with every
layer leaf STACKED on a leading ``num_layers`` dim
(``{"embedding": {"weight"}, "pos_embedding", "final_ln": {"scale",
"bias"}, "layers": {"ln1": ..., "qkv": {"weight", "bias"}, ...}}``).  The
port's ``GPTModel`` is an ``nn.Module`` with a ``ModuleList`` of layers,
so its state dict names ``layers.<i>.qkv.weight`` and so on.  Both keep
the same per-leaf layouts (linear weights ``(in, out)``, the qkv output
grouped per head, the LM head tied to ``embedding.weight``), so the
bridge only flattens/unstacks the tree: values are copied bit for bit
and a round trip is exact.

Takes and returns numpy arrays (``jax.tree.map(np.asarray, params)`` on
the JAX side), so neither package imports the other.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax"]


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX GPT parameter tree (numpy leaves) -> the port's state dict
    (CPU tensors; ``GPTModel.load_state_dict`` moves them)."""
    state: Dict[str, torch.Tensor] = {}
    for key, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if key[0] == "layers":
            for i in range(arr.shape[0]):
                state[".".join(("layers", str(i)) + key[1:])] = \
                    torch.from_numpy(np.array(arr[i]))
        else:
            state[".".join(key)] = torch.from_numpy(np.array(arr))
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state dict -> the JAX GPT parameter tree (numpy
    leaves, layer leaves stacked on a leading ``num_layers`` dim)."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
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
