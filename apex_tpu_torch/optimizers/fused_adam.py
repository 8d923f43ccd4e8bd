"""FusedAdam: Adam/AdamW with fp32 math, optional fp32 masters and a
global-norm gradient clip.

Counterpart of ``apex_tpu/optimizers/fused_adam.py``, plain PyTorch as the
JAX optimizer is plain XLA (no TPU kernel).  The math is the same, with
the coefficients rounded to fp32 as JAX computes them:

- the step counter increments before the bias corrections
  ``bc1 = 1 - b1**step``, ``bc2 = 1 - b2**step`` (1 without
  ``bias_correction``);
- ``adam_w_mode=True`` adds ``weight_decay * p`` to the update (AdamW),
  ``False`` adds it to the gradient (L2);
- ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
  ``p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)``;
- ``exp_avg_sq_dtype`` stores the second moment in another dtype (the
  math stays fp32);
- ``max_grad_norm`` scales every gradient by ``max_grad_norm / norm``
  when the global norm (fp32, :func:`global_l2norm`) exceeds it.

``fused_tail=True`` raises: ROADMAP.md queue A item 5.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.multi_tensor_apply import global_l2norm
from apex_tpu_torch.optimizers.base import FusedOptimizer, f32

__all__ = ["FusedAdam"]


class FusedAdam(FusedOptimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        bias_correction: bool = True,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        adam_w_mode: bool = True,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        master_weights: bool = False,
        max_grad_norm: Optional[float] = None,
        fused_tail: bool = False,
        exp_avg_sq_dtype: torch.dtype = torch.float32,
    ):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        if not exp_avg_sq_dtype.is_floating_point:
            raise ValueError(
                f"exp_avg_sq_dtype must be floating, got {exp_avg_sq_dtype}")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, adam_w_mode=adam_w_mode,
                        weight_decay=weight_decay)
        super().__init__(params, defaults, master_weights=master_weights,
                         fused_tail=fused_tail)
        self.max_grad_norm = max_grad_norm
        self.exp_avg_sq_dtype = exp_avg_sq_dtype

    def _init_extra(self, p: torch.Tensor) -> dict:
        return {
            "exp_avg": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
            "exp_avg_sq": torch.zeros(p.shape, dtype=self.exp_avg_sq_dtype,
                                      device=p.device),
        }

    def _prepare(self, grads):
        """The clip factor (a 0-d fp32 tensor on the device), or None."""
        if self.max_grad_norm is None or self.max_grad_norm <= 0:
            return None
        gnorm = global_l2norm(grads)
        return torch.where(gnorm > self.max_grad_norm,
                           self.max_grad_norm / gnorm,
                           torch.ones_like(gnorm))

    def _update(self, group, state, g, p, clip):
        b1, b2 = np.float32(group["betas"][0]), np.float32(group["betas"][1])
        one = np.float32(1.0)
        if group["bias_correction"]:
            stepf = np.float32(state["step"])
            bc1, bc2 = float(one - b1 ** stepf), float(one - b2 ** stepf)
        else:
            bc1 = bc2 = 1.0
        wd = f32(group["weight_decay"])
        if clip is not None:
            g = g * clip
        if not group["adam_w_mode"] and wd != 0.0:
            g = g + wd * p
        m = state["exp_avg"] * float(b1) + g * float(one - b1)
        v = (state["exp_avg_sq"].float() * float(b2)
             + torch.square(g) * float(one - b2))
        denom = torch.sqrt(v / bc2) + group["eps"]
        update = (m / bc1) / denom
        if group["adam_w_mode"] and wd != 0.0:
            update = update + wd * p
        state["exp_avg"] = m
        state["exp_avg_sq"] = v.to(self.exp_avg_sq_dtype)
        return p - f32(group["lr"]) * update
