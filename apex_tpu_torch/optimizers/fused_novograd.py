"""FusedNovoGrad: NovoGrad with a per-tensor second moment.

Counterpart of ``apex_tpu/optimizers/fused_novograd.py``, in plain
PyTorch over ``torch._foreach_*`` (JAX's is XLA, and no training path at
scale uses it), with each gradient's sum of squares from the
``multi_tensor_l2norm`` kernel on the card: the second moment is one
fp32 scalar a tensor, set to that sum at the first step (``init_zero``
False) or grown from 0, ``d = g / (sqrt(v / bc2) + eps)``, the first
moment ``b1 m + beta3 d``, the decay inside the moment or on the update.
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops.multi_tensor import commit
from apex_tpu_torch.optimizers.base import FusedOptimizer, f32

__all__ = ["FusedNovoGrad"]


class FusedNovoGrad(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.95, 0.98),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_averaging: bool = True,
                 reg_inside_moment: bool = False, norm_type: int = 2,
                 init_zero: bool = False, master_weights: bool = False):
        if norm_type != 2:
            raise ValueError("FusedNovoGrad only supports norm_type=2")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        reg_inside_moment=reg_inside_moment,
                        init_zero=init_zero)
        super().__init__(params, defaults, master_weights=master_weights)

    def _init_extra(self, p: torch.Tensor) -> dict:
        return {
            "exp_avg": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
            # one second moment a tensor
            "exp_avg_sq": torch.zeros((), dtype=torch.float32,
                                      device=p.device),
        }

    def _apply(self, entries, grads, new_step, finite, inv_scale, shared):
        first = new_step == 1
        for group, items in self._groups(entries):
            b1, b2 = (f32(b) for b in group["betas"])
            beta3 = (f32(np.float32(1.0) - np.float32(b1))
                     if group["grad_averaging"] else 1.0)
            omb2 = f32(np.float32(1.0) - np.float32(b2))
            bc1, bc2 = self._bias_corrections(group, new_step)
            wd = f32(group["weight_decay"])
            states = [s for _, _, s in items]
            params = [p for _, p, _ in items]
            work = [s["master"] if self.master_weights else p.float()
                    for p, s in zip(params, states)]
            g = [p.grad.float() for p in params]
            sq = mt.l2norm(g, per_tensor=True).sq.unbind()
            vs = [s["exp_avg_sq"] for s in states]
            grown = torch._foreach_add(torch._foreach_mul(vs, b2),
                                       torch._foreach_mul(list(sq), omb2))
            new_v = grown if group["init_zero"] else [
                torch.where(first, q, r) for q, r in zip(sq, grown)]
            vh = new_v if bc2 is None else [v / bc2 for v in new_v]
            denom = torch._foreach_add(torch._foreach_sqrt(vh),
                                       f32(group["eps"]))
            d = [gi / di for gi, di in zip(g, denom)]
            if wd != 0.0 and group["reg_inside_moment"]:
                d = torch._foreach_add(d, torch._foreach_mul(work, wd))
            ms = [s["exp_avg"] for s in states]
            new_m = torch._foreach_add(torch._foreach_mul(ms, b1),
                                       torch._foreach_mul(d, beta3))
            update = new_m if bc1 is None else [m / bc1 for m in new_m]
            if wd != 0.0 and not group["reg_inside_moment"]:
                update = torch._foreach_add(update,
                                            torch._foreach_mul(work, wd))
            new = torch._foreach_sub(work, torch._foreach_mul(
                update, f32(group["lr"])))
            for p, s, m, v, n in zip(params, states, new_m, new_v, new):
                commit(s["exp_avg"], m, finite)
                commit(s["exp_avg_sq"], v, finite)
                if self.master_weights:
                    commit(s["master"], n, finite)
                commit(p, n, finite)
