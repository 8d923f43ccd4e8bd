"""Shared machinery of the fused optimizers.

Counterpart of ``apex_tpu/optimizers/base.py``.  The JAX optimizers are
pure ``(state, grads, params) -> (params, state)`` functions; here they
are ``torch.optim.Optimizer``s that keep the same per-parameter state
(``step``, the moments, and with ``master_weights=True`` an fp32
``master``) and update ``p`` in place:

- the math runs in fp32 whatever the storage dtype;
- with master weights the update runs on the fp32 master and ``p``
  receives the master cast to its own dtype (the JAX ``step`` returns
  that cast as the new params);
- the step counter is incremented before the update, as in JAX.

Not ported (ROADMAP.md queue A item 5): ``fused_tail`` (the packed
multi-tensor tail), ``step_scaled`` and the ``grads_finite`` skip-step of
the loss scaler.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["FusedOptimizer", "f32"]


def f32(x: float) -> float:
    """``x`` rounded to fp32 (as a Python float), so that scalar
    coefficients carry the values the JAX package computes in fp32."""
    return float(np.float32(x))


class FusedOptimizer(torch.optim.Optimizer):
    """Base class: subclasses implement ``_init_extra(p)`` (their state
    besides ``step`` and ``master``), ``_prepare(grads)`` (a value shared
    by every parameter's update, such as a clip factor) and
    ``_update(group, state, grad, param, shared)``, which returns the new
    fp32 parameter and updates the state in place; ``grad`` and ``param``
    arrive fp32 and must not be modified."""

    def __init__(self, params, defaults: Dict[str, Any],
                 master_weights: bool = False, fused_tail: bool = False):
        if fused_tail:
            raise NotImplementedError(
                "fused_tail (the packed multi-tensor optimizer tail) is not "
                "ported yet (ROADMAP.md queue A item 5)")
        super().__init__(params, defaults)
        self.master_weights = master_weights

    # -- provided by subclasses ------------------------------------------
    def _init_extra(self, p: torch.Tensor) -> dict:
        raise NotImplementedError

    def _prepare(self, grads):
        return None

    def _update(self, group, state, grad, param, shared) -> torch.Tensor:
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = 0
            state.update(self._init_extra(p))
            if self.master_weights:
                state["master"] = p.detach().to(torch.float32, copy=True)
        return state

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        """One update of every parameter that has a gradient.  Nothing
        here synchronises with the host."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = {p: p.grad.float() for p in params}
        shared = self._prepare(list(grads.values()))
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self._state(p)
                state["step"] += 1
                work = (state["master"] if self.master_weights
                        else p.detach().float())
                new = self._update(group, state, grads[p], work, shared)
                if self.master_weights:
                    state["master"] = new
                p.copy_(new)
        return loss
