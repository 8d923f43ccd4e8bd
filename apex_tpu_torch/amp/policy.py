"""Precision policies: the O0-O5 presets as data.

Counterpart of ``apex_tpu/amp/policy.py``: one frozen :class:`Policy`
per optimization level names the parameter, compute and output dtypes,
whether norms keep fp32 parameters, whether the optimizer keeps fp32
master weights, and the loss scale.  ``GPTConfig(policy=...)`` takes its
dtypes from it, ``FusedAdam(master_weights=policy.master_weights)`` its
masters, and ``amp.initialize`` its loss scaler.  :func:`tree_cast` and
the ``cast_to_*`` methods cast a tree of tensors (nested dicts, lists or
tuples, such as a state dict) the way JAX's cast a pytree, with
:func:`is_norm_param` keeping norm parameters fp32.

Every level trains: O0 (fp32, a static loss scale of 1.0 and the
scaler's overflow skip-step), O1 (fp32 params, fp16 compute, dynamic
scaling), O2 (fp16 params, fp32 norms and masters, dynamic scaling), O3
(pure fp16), O4 (bf16 compute, fp32 params) and O5 (bf16 params and
compute, fp32 norms and masters, the default), with any loss scale,
static or dynamic, put on them (``get_policy(..., loss_scale=...)``).
Every level serves too, at its compute dtype, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

__all__ = ["Policy", "OPT_LEVELS", "get_policy", "check_ported",
           "tree_cast", "is_norm_param"]

_NORM_KEY_FRAGMENTS = (
    "batchnorm",
    "bn",
    "layernorm",
    "layer_norm",
    "ln",
    "norm",
    "groupnorm",
    "rmsnorm",
    "scale",
)


def is_norm_param(path: tuple, _leaf=None) -> bool:
    """Does a tree path name a normalization parameter?  The path's
    entries are names (``("layers", "0", "ln1", "scale")``, or one
    dotted state-dict key), or objects with a ``key`` or ``name`` as JAX's
    path entries have; a common fragment anywhere in one (``ln``,
    ``norm``, ``scale``, ...) matches, as in JAX."""
    if isinstance(path, str):
        path = (path,)
    for entry in path:
        name = entry if isinstance(entry, (str, int)) else (
            getattr(entry, "key", None) or getattr(entry, "name", None))
        if name is None:
            continue
        lowered = str(name).lower()
        if any(frag in lowered for frag in _NORM_KEY_FRAGMENTS):
            return True
    return False


def _cast_leaf(leaf: Any, dtype: Optional[torch.dtype]) -> Any:
    if dtype is not None and isinstance(leaf, torch.Tensor) and \
            leaf.is_floating_point():
        return leaf.to(dtype)
    return leaf


def tree_cast(tree: Any, dtype: Optional[torch.dtype], *,
              keep_fp32_predicate: Optional[Callable[[tuple], bool]] = None
              ) -> Any:
    """Cast every floating tensor of ``tree`` (nested dicts, lists and
    tuples) to ``dtype``; those whose path (the tuple of keys and indices
    down to it) satisfies ``keep_fp32_predicate`` become fp32.  A new
    tree; a tensor already of its dtype is returned as it is."""
    if dtype is None:
        return tree

    def walk(node, path):
        if isinstance(node, dict):
            return type(node)((k, walk(v, path + (k,)))
                              for k, v in node.items())
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        keep = keep_fp32_predicate is not None and keep_fp32_predicate(path)
        return _cast_leaf(node, torch.float32 if keep else dtype)

    return walk(tree, ())


@dataclasses.dataclass(frozen=True)
class Policy:
    """A frozen precision policy.  ``loss_scale``: "dynamic" for O1/O2,
    1.0 for O0/O3, None (no scaling at all) for the bf16 levels."""

    opt_level: str = "O5"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: Optional[torch.dtype] = None
    keep_norm_fp32: bool = True
    master_weights: bool = False
    loss_scale: Optional[Union[float, str]] = None

    # -- casting helpers -------------------------------------------------
    def cast_to_param(self, tree: Any) -> Any:
        pred = is_norm_param if self.keep_norm_fp32 else None
        return tree_cast(tree, self.param_dtype, keep_fp32_predicate=pred)

    def cast_to_compute(self, tree: Any) -> Any:
        return tree_cast(tree, self.compute_dtype)

    def cast_to_output(self, tree: Any) -> Any:
        return tree_cast(tree, self.output_dtype or self.compute_dtype)

    def cast_to_master(self, tree: Any) -> Any:
        return tree_cast(tree, torch.float32)

    # -- properties ------------------------------------------------------
    @property
    def uses_loss_scaling(self) -> bool:
        return self.loss_scale is not None

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == "dynamic"

    @property
    def low_precision(self) -> bool:
        return (self.param_dtype != torch.float32
                or self.compute_dtype != torch.float32)

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        lines = [f"apex_tpu_torch.amp policy: {self.opt_level}"]
        for f in dataclasses.fields(self):
            lines.append(f"  {f.name:18s}: {getattr(self, f.name)}")
        return "\n".join(lines)


OPT_LEVELS = {
    "O0": Policy(opt_level="O0", param_dtype=torch.float32,
                 compute_dtype=torch.float32, keep_norm_fp32=False,
                 master_weights=False, loss_scale=1.0),
    "O1": Policy(opt_level="O1", param_dtype=torch.float32,
                 compute_dtype=torch.float16, output_dtype=torch.float32,
                 keep_norm_fp32=True, master_weights=False,
                 loss_scale="dynamic"),
    "O2": Policy(opt_level="O2", param_dtype=torch.float16,
                 compute_dtype=torch.float16, keep_norm_fp32=True,
                 master_weights=True, loss_scale="dynamic"),
    "O3": Policy(opt_level="O3", param_dtype=torch.float16,
                 compute_dtype=torch.float16, keep_norm_fp32=False,
                 master_weights=False, loss_scale=1.0),
    "O4": Policy(opt_level="O4", param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, output_dtype=torch.float32,
                 keep_norm_fp32=True, master_weights=False,
                 loss_scale=None),
    "O5": Policy(opt_level="O5", param_dtype=torch.bfloat16,
                 compute_dtype=torch.bfloat16, keep_norm_fp32=True,
                 master_weights=True, loss_scale=None),
}


def get_policy(opt_level: str = "O5", **overrides) -> Policy:
    """A preset plus the overrides whose value is not None."""
    if opt_level not in OPT_LEVELS:
        raise ValueError(
            f"Unexpected optimization level {opt_level!r}. Options are "
            "'O0', 'O1', 'O2', 'O3', 'O4', 'O5'. Note that in 'O0', 'O1', "
            "etc., the prefix O is the letter O, not the number zero.")
    clean = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(OPT_LEVELS[opt_level], **clean)


#: the element types the training path's kernels take
TRAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def check_ported(policy: Policy) -> None:
    """Raise for a policy the port cannot train: a parameter or compute
    dtype its kernels do not take.  Every opt level O0-O5 trains, with any
    loss scale."""
    for name in ("param_dtype", "compute_dtype"):
        dtype = getattr(policy, name)
        if dtype not in TRAIN_DTYPES:
            raise NotImplementedError(
                f"opt level {policy.opt_level}: {name} {dtype} is not one "
                f"of the kernels' {TRAIN_DTYPES}")

