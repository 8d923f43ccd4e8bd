"""FusedAdam: Adam/AdamW with fp32 math, optional fp32 masters, a
global-norm gradient clip and the packed fused tail.

Counterpart of ``apex_tpu/optimizers/fused_adam.py``.  The update of a
whole dtype group is one launch of the ``multi_tensor_adam`` kernel
(``ops/multi_tensor.py``; its plain version on CPU tensors), with the
coefficients rounded to fp32 as JAX computes them:

- the bias corrections ``bc1 = 1 - b1**step``, ``bc2 = 1 - b2**step``
  (1 without ``bias_correction``) are device scalars computed once a step
  from the counter plus one;
- ``adam_w_mode=True`` adds ``weight_decay * p`` to the update (AdamW),
  ``False`` adds it to the gradient (L2);
- ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
  ``p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)``;
- ``exp_avg_sq_dtype`` stores the second moment in another dtype (the
  math stays fp32; the kernel takes fp32 and bf16);
- ``max_grad_norm`` multiplies every gradient by ``max_grad_norm / norm``
  when the global norm (``multi_tensor_l2norm``) exceeds it;
- ``fused_tail=True`` keeps the moments and masters in packed buckets
  (``bucket_bytes``, :mod:`~apex_tpu_torch.optimizers.fused_tail`).
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers.base import FusedOptimizer

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
        bucket_bytes: Optional[int] = None,
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
        """The clip factor (a 0-d fp32 device tensor) from the global norm
        of the (unscaled) gradients, and that pass's finite flag; ``(None,
        None)`` without a clip."""
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
            mt.adam([p.grad for _, p, _ in items],
                    self._step_rows(mt.KERNEL_ADAM, items), lr=group["lr"],
                    beta1=b1, beta2=b2, eps=group["eps"],
                    weight_decay=group["weight_decay"],
                    adam_w_mode=group["adam_w_mode"], bc1=bc1, bc2=bc2,
                    clip=clip, inv_scale=inv_scale, finite=finite)
