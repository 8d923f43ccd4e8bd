"""Precision policies: the O0-O5 presets as data.

Counterpart of ``apex_tpu/amp/policy.py``: one frozen :class:`Policy`
per optimization level names the parameter, compute and output dtypes,
whether norms keep fp32 parameters, whether the optimizer keeps fp32
master weights, and the loss scale.  ``GPTConfig(policy=...)`` takes its
dtypes from it, and ``FusedAdam(master_weights=policy.master_weights)``
its masters.

What this slice runs: O0 (fp32), O4 (bf16 compute, fp32 params) and O5
(bf16 params and compute, fp32 norms and masters, the default), none of
which needs a dynamic loss scaler.  :func:`check_ported` raises for the
fp16 levels (O1-O3): their dynamic ``LossScaler`` and fp16 compute are
ROADMAP.md queue A item 5.  O0's static loss scale of 1.0 multiplies by
one; the overflow skip-step that the JAX scaler adds to it is item 5 too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

__all__ = ["Policy", "OPT_LEVELS", "get_policy", "check_ported"]


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

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == "dynamic"


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


def check_ported(policy: Policy) -> None:
    """Raise for a policy this slice cannot run: fp16 parameters or
    compute, or a dynamic loss scale."""
    if (policy.dynamic_loss_scale or torch.float16 in (
            policy.param_dtype, policy.compute_dtype)):
        raise NotImplementedError(
            f"opt level {policy.opt_level}: fp16 compute and the dynamic "
            "LossScaler are not ported yet (ROADMAP.md queue A item 5); "
            "O0, O4 and O5 run")
