"""FusedAdagrad: Adagrad with L2 or decoupled (``adagrad_w_mode``) weight
decay.

Counterpart of ``apex_tpu/optimizers/fused_adagrad.py``, in plain PyTorch
over ``torch._foreach_*`` (JAX's is XLA, and no training path at scale
uses it): ``h += g^2``, ``p -= lr * g / (sqrt(h) + eps)``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.multi_tensor import commit
from apex_tpu_torch.optimizers.base import FusedOptimizer, f32

__all__ = ["FusedAdagrad"]


class FusedAdagrad(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False,
                 master_weights: bool = False):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay,
                        adagrad_w_mode=adagrad_w_mode)
        super().__init__(params, defaults, master_weights=master_weights)

    def _init_extra(self, p: torch.Tensor) -> dict:
        return {"sum": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)}

    def _apply(self, entries, grads, new_step, finite, inv_scale, shared):
        for group, items in self._groups(entries):
            wd = f32(group["weight_decay"])
            states = [s for _, _, s in items]
            params = [p for _, p, _ in items]
            work = [s["master"] if self.master_weights else p.float()
                    for p, s in zip(params, states)]
            g = [p.grad.float() for p in params]
            if wd != 0.0 and not group["adagrad_w_mode"]:
                g = torch._foreach_add(g, torch._foreach_mul(work, wd))
            h = torch._foreach_add([s["sum"] for s in states],
                                   torch._foreach_mul(g, g))
            denom = torch._foreach_add(torch._foreach_sqrt(h),
                                       f32(group["eps"]))
            update = torch._foreach_div(g, denom)
            if wd != 0.0 and group["adagrad_w_mode"]:
                update = torch._foreach_add(update,
                                            torch._foreach_mul(work, wd))
            new = torch._foreach_sub(work, torch._foreach_mul(
                update, f32(group["lr"])))
            for p, s, hi, n in zip(params, states, h, new):
                commit(s["sum"], hi, finite)
                if self.master_weights:
                    commit(s["master"], n, finite)
                commit(p, n, finite)
