"""FusedLAMB: LAMB with a global-norm clip and a per-tensor trust ratio.

Counterpart of ``apex_tpu/optimizers/fused_lamb.py``, on the
``multi_tensor_lamb`` kernel (``ops/multi_tensor.py``; its plain version
on CPU tensors):

1. the global L2 norm of the gradients (``multi_tensor_l2norm``) and the
   clip factor ``max_grad_norm / norm`` where the norm exceeds it;
2. Adam-style moments with bias correction (``grad_averaging`` weighs
   the gradient by ``1 - b1``, else 1), L2 decay folded into the gradient
   (``adam_w_mode=False``) or AdamW decay added to the update;
3. each tensor's trust ratio ``|p| / |update|`` (1 where either norm is
   0), applied to the learning rate; without weight decay only with
   ``use_nvlamb=True``, as JAX's ``_trust``.

``fused_tail=True`` keeps the moments and masters in packed buckets
(:mod:`~apex_tpu_torch.optimizers.fused_tail`); ``exp_avg_sq_dtype`` stores
the second moment in fp32 or bf16.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers.base import FusedOptimizer

__all__ = ["FusedLAMB"]


class FusedLAMB(FusedOptimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        bias_correction: bool = True,
        betas=(0.9, 0.999),
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        amsgrad: bool = False,
        adam_w_mode: bool = True,
        grad_averaging: bool = True,
        max_grad_norm: float = 1.0,
        use_nvlamb: bool = False,
        master_weights: bool = False,
        fused_tail: bool = False,
        bucket_bytes: Optional[int] = None,
        exp_avg_sq_dtype: torch.dtype = torch.float32,
    ):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad variant.")
        if not exp_avg_sq_dtype.is_floating_point:
            raise ValueError(
                f"exp_avg_sq_dtype must be floating, got {exp_avg_sq_dtype}")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        adam_w_mode=adam_w_mode,
                        grad_averaging=grad_averaging, use_nvlamb=use_nvlamb)
        self.max_grad_norm = max_grad_norm
        self.exp_avg_sq_dtype = exp_avg_sq_dtype
        super().__init__(params, defaults, master_weights=master_weights,
                         fused_tail=fused_tail, bucket_bytes=bucket_bytes)

    def _init_extra(self, p: torch.Tensor) -> dict:
        return {
            "exp_avg": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
            "exp_avg_sq": torch.zeros(p.shape, dtype=self.exp_avg_sq_dtype,
                                      device=p.device),
        }

    def _tail_state_dtypes(self) -> dict:
        return {"exp_avg": torch.float32,
                "exp_avg_sq": self.exp_avg_sq_dtype}

    def _prepare(self, grads, inv_scale):
        """The clip factor from the global norm (``(None, None)`` without
        ``max_grad_norm``), and that pass's finite flag."""
        if self.max_grad_norm is None or self.max_grad_norm <= 0:
            return None, None
        norms = mt.l2norm(grads, inv_scale=inv_scale)
        gnorm = norms.total
        clip = torch.where(gnorm > self.max_grad_norm,
                           gnorm.new_full((), self.max_grad_norm) / gnorm,
                           torch.ones_like(gnorm))
        return clip, norms.finite

    def _apply(self, entries, grads, new_step, finite, inv_scale, clip):
        for group, items in self._groups(entries):
            bc1, bc2 = self._bias_corrections(group, new_step)
            b1, b2 = group["betas"]
            beta3 = (np.float32(1.0) - np.float32(b1)
                     if group["grad_averaging"] else 1.0)
            wd = group["weight_decay"]
            mt.lamb([p.grad for _, p, _ in items],
                    self._step_rows(mt.KERNEL_LAMB, items), lr=group["lr"],
                    beta1=b1, beta2=b2, beta3=beta3, eps=group["eps"],
                    weight_decay=wd, adam_w_mode=group["adam_w_mode"],
                    use_trust=wd != 0.0 or group["use_nvlamb"], bc1=bc1,
                    bc2=bc2, clip=clip, inv_scale=inv_scale, finite=finite)
