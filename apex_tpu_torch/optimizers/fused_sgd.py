"""FusedSGD: SGD with momentum, dampening, Nesterov and weight decay.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py``, in plain PyTorch
over ``torch._foreach_*`` (JAX's is XLA, and no training path at scale
uses it): the momentum buffer starts as the first gradient (torch's
rule), ``wd_after_momentum`` adds the decay after the momentum, and every
operation is rounded in fp32 as JAX's.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.multi_tensor import commit
from apex_tpu_torch.optimizers.base import FusedOptimizer, f32

__all__ = ["FusedSGD"]


class FusedSGD(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False,
                 materialize_master_grads: bool = True,
                 master_weights: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov,
                        wd_after_momentum=wd_after_momentum)
        self.materialize_master_grads = materialize_master_grads
        super().__init__(params, defaults, master_weights=master_weights)

    def _init_extra(self, p: torch.Tensor) -> dict:
        if self.defaults["momentum"] == 0.0:
            return {}
        return {"momentum_buffer": torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)}

    def _apply(self, entries, grads, new_step, finite, inv_scale, shared):
        first = new_step == 1
        for group, items in self._groups(entries):
            mu, wd = f32(group["momentum"]), f32(group["weight_decay"])
            states = [s for _, _, s in items]
            params = [p for _, p, _ in items]
            work = [s["master"] if self.master_weights else p.float()
                    for p, s in zip(params, states)]
            g = [p.grad.float() for p in params]
            if wd != 0.0 and not group["wd_after_momentum"]:
                g = torch._foreach_add(g, torch._foreach_mul(work, wd))
            d = g
            if mu != 0.0:
                bufs = [s["momentum_buffer"] for s in states]
                damp = f32(1.0 - f32(group["dampening"]))
                run = torch._foreach_add(torch._foreach_mul(bufs, mu),
                                         torch._foreach_mul(g, damp))
                new_bufs = [torch.where(first, gi, ri)
                            for gi, ri in zip(g, run)]
                d = (torch._foreach_add(g, torch._foreach_mul(new_bufs, mu))
                     if group["nesterov"] else new_bufs)
                for b, nb in zip(bufs, new_bufs):
                    commit(b, nb, finite)
            if wd != 0.0 and group["wd_after_momentum"]:
                d = torch._foreach_add(d, torch._foreach_mul(work, wd))
            new = torch._foreach_sub(work, torch._foreach_mul(
                d, f32(group["lr"])))
            for p, s, n in zip(params, states, new):
                if self.master_weights:
                    commit(s["master"], n, finite)
                commit(p, n, finite)
