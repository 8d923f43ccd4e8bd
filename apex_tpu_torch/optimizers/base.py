"""Shared machinery of the fused optimizers.

Counterpart of ``apex_tpu/optimizers/base.py``.  The JAX optimizers are
pure ``(state, grads, params) -> (params, state)`` functions; here they
are ``torch.optim.Optimizer``s that keep the same state (``step``, the
moments, and with ``master_weights=True`` an fp32 ``master``) and update
``p`` in place:

- the math runs in fp32 whatever the storage dtype; with master weights
  the update runs on the fp32 master and ``p`` receives the master
  rounded to its own dtype;
- ``state["step"]`` is one 0-d int32 device tensor, the same for every
  parameter, as JAX's one counter is; a step reads it plus one for the
  bias corrections and advances it after its launches only where the
  step was finite;
- ``step(grads_finite=)`` is JAX's skip-step: where the device flag is
  false the parameters, moments, masters and step stay as they were, bit
  for bit;
- :meth:`FusedOptimizer.step_scaled` is the loss scaler's tail in one
  call (unscale, the finite check, the step), returning the flag for
  ``LossScaler.adjust``; with ``fused_tail=True`` the unscale folds into
  the step kernel's read of the gradients;
- ``fused_tail=True`` keeps the state in the packed buckets of
  :mod:`apex_tpu_torch.optimizers.fused_tail`, each parameter's state a
  view into them; :meth:`FusedOptimizer.unpack_state` reads it per
  parameter.

FusedAdam and FusedLAMB run their update through the multi-tensor
kernels (``ops/multi_tensor.py``): one launch a dtype group, and no host
synchronisation anywhere in a step.  Parameters without a gradient are
skipped (their state does not move), where JAX updates every leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops import multi_tensor as mt

__all__ = ["FusedOptimizer", "f32"]


def f32(x: float) -> float:
    """``x`` rounded to fp32 (as a Python float), so that scalar
    coefficients carry the values the JAX package computes in fp32."""
    return float(np.float32(x))


class _Tail:
    """The packed state of a fused-tail optimizer: the plan and the
    buffers ``{key: {bucket name: flat tensor}}``."""

    def __init__(self, plan, bufs):
        self.plan, self.bufs = plan, bufs


class FusedOptimizer(torch.optim.Optimizer):
    """Base class.  Subclasses give ``_init_extra(p)`` (their per-leaf
    state besides ``step`` and ``master``, zeros), ``_prepare(grads,
    inv_scale)`` (a value shared by the whole step, such as a clip factor,
    and the finite flag of the gradients if computing it read them) and
    ``_apply(entries, grads, new_step, finite, inv_scale, shared)``,
    which updates every ``(group, p, state)`` of ``entries`` in place and
    writes nothing where ``finite`` is false.  ``_tail_state_dtypes()``
    names the packed state of the optimizers that have a fused tail."""

    def __init__(self, params, defaults: Dict[str, Any],
                 master_weights: bool = False, fused_tail: bool = False,
                 bucket_bytes: Optional[int] = None):
        super().__init__(params, defaults)
        self.master_weights = master_weights
        self.fused_tail = fused_tail
        self.bucket_bytes = bucket_bytes
        self._counter_t: Optional[torch.Tensor] = None
        self._tail: Optional[_Tail] = None
        self._rows: Dict[Tuple, mt.StepRows] = {}
        if fused_tail:
            self._require_tail()

    # -- provided by subclasses ------------------------------------------
    def _init_extra(self, p: torch.Tensor) -> dict:
        raise NotImplementedError

    def _prepare(self, grads: List[torch.Tensor],
                 inv_scale: Optional[torch.Tensor]):
        return None, None

    def _apply(self, entries, grads, new_step, finite, inv_scale,
               shared) -> None:
        raise NotImplementedError

    def _tail_state_dtypes(self) -> Optional[Dict[str, torch.dtype]]:
        return None

    def _require_tail(self) -> None:
        if self._tail_state_dtypes() is None:
            raise ValueError(
                f"fused_tail=True is not supported by {type(self).__name__} "
                "(only FusedAdam / FusedLAMB implement the multi-tensor tail "
                "pass)")

    # -- state -------------------------------------------------------------
    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def _counter(self, device: torch.device) -> torch.Tensor:
        """The step counter shared by every parameter's state."""
        if self._counter_t is None:
            self._counter_t = torch.zeros((), dtype=torch.int32,
                                          device=device)
        return self._counter_t

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = self._counter(p.device)
            state.update(self._init_extra(p))
            if self.master_weights:
                state["master"] = p.detach().to(torch.float32, copy=True)
        return state

    def _tail_plan(self, params):
        from apex_tpu_torch.optimizers.fused_tail import (
            DEFAULT_BUCKET_BYTES,
            tail_plan,
        )

        return tail_plan(params, self.bucket_bytes or DEFAULT_BUCKET_BYTES)

    def _ensure_tail(self) -> _Tail:
        """The packed buffers, made at the first step (or after a load):
        zeros, the masters packed from the parameters; a parameter's state
        that already holds values (a loaded one) is copied in.  Each
        parameter's state becomes views of the buffers."""
        if self._tail is not None:
            return self._tail
        from apex_tpu_torch.optimizers.fused_tail import TailContext

        params = self._params()
        devices = {p.device for p in params}
        if len(devices) != 1:
            raise ValueError(f"fused_tail needs every parameter on one "
                             f"device, got {sorted(map(str, devices))}")
        dev = devices.pop()
        plan = self._tail_plan(params)
        keys = dict(self._tail_state_dtypes())
        if self.master_weights:
            keys["master"] = torch.float32
        bufs = {k: {name: torch.zeros((b.size,), dtype=dt, device=dev)
                    for name, b in zip(plan.names, plan.buckets)}
                for k, dt in keys.items()}
        ctx = TailContext(plan, tuple(tuple(p.shape) for p in params))
        views = {k: ctx.views(bufs[k]) for k in keys}
        counter = self._counter(dev)
        for i, p in enumerate(params):
            old = self.state[p]
            new = {"step": counter}
            for k in keys:
                view = views[k][i]
                src = old.get(k)
                if src is None and k == "master":
                    src = p.detach()
                if src is not None:
                    view.copy_(src.reshape(view.shape))
                new[k] = view
            self.state[p] = new
        self._tail = _Tail(plan, bufs)
        self._rows.clear()
        return self._tail

    def _relink(self) -> None:
        """After state was loaded from outside (``load_state_dict``,
        ``convert.optimizer_state_from_jax``): one shared step counter,
        and for a fused tail the loaded values packed into fresh buffers.
        Reads the loaded steps on the host."""
        params = [p for p in self._params() if self.state.get(p)]
        self._rows.clear()
        self._tail = None
        self._counter_t = None
        if not params:
            return
        steps = {int(self.state[p]["step"]) for p in params}
        if len(steps) != 1:
            raise ValueError(f"parameters are at different steps "
                             f"{sorted(steps)}; the port keeps one counter")
        counter = self._counter(params[0].device)
        counter.fill_(steps.pop())
        for p in params:
            self.state[p]["step"] = counter
        if self.fused_tail:
            self._ensure_tail()

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self._relink()

    def unpack_state(self) -> Dict[str, Any]:
        """The state per parameter: ``{"step": counter, key: [one tensor a
        parameter, in ``param_groups`` order, None where it has no
        state]}``; with ``fused_tail`` fp32 copies sliced out of the
        buffers (as JAX's ``unpack_state`` gives them), else the state
        tensors themselves."""
        params = self._params()
        keys = list(self._tail_state_dtypes() or ())
        if not keys:
            keys = sorted({k for p in params for k in self.state.get(p, {})
                           if k not in ("step", "master")})
        if self.master_weights:
            keys.append("master")
        out: Dict[str, Any] = {"step": self._counter_t}
        for k in keys:
            vals = []
            for p in params:
                t = self.state.get(p, {}).get(k)
                if t is not None and self.fused_tail:
                    t = t.to(torch.float32, copy=True)
                vals.append(t)
            out[k] = vals
        return out

    # -- the step ----------------------------------------------------------
    def _entries(self):
        return [(g, p) for g in self.param_groups for p in g["params"]
                if p.grad is not None]

    def _step(self, grads_finite=None, inv_scale=None, finite_reduce=None):
        entries = self._entries()
        if not entries:
            return grads_finite
        if self.fused_tail:
            self._ensure_tail()
        states = [self._state(p) for _, p in entries]
        grads = [p.grad for _, p in entries]
        counter = states[0]["step"]
        finite, fold = grads_finite, None
        if inv_scale is not None:
            if self.fused_tail:
                # the unscale folds into the step's read of the gradients;
                # the flag comes from the incoming values, from the clip's
                # norm pass where there is one, else a check of its own
                shared, local = self._prepare(grads, inv_scale)
                if local is None:
                    local = mt.scale(grads)
                fold = inv_scale
            else:
                # JAX's unfused order: the check, the unscale (in place,
                # one pass), then the step on the unscaled gradients
                local = mt.scale(grads, inv_scale, out=grads)
                shared, _ = self._prepare(grads, None)
            finite = local if finite_reduce is None else finite_reduce(local)
        else:
            shared, _ = self._prepare(grads, None)
        new_step = counter + 1
        self._apply([(g, p, s) for (g, p), s in zip(entries, states)], grads,
                    new_step, finite, fold, shared)
        if finite is None:
            counter.add_(1)
        else:
            counter.add_(finite.to(counter.dtype))
        return finite

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None,
             grads_finite: Optional[torch.Tensor] = None):
        """One update of every parameter that has a gradient; with
        ``grads_finite`` (a 0-d bool device tensor) false, nothing moves.
        Nothing here synchronises with the host."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step(grads_finite=grads_finite)
        return loss

    @torch.no_grad()
    def step_scaled(self, inv_scale: torch.Tensor,
                    finite_reduce: Optional[Callable] = None
                    ) -> torch.Tensor:
        """The amp tail in one call: the gradients as the loss scaler
        left them (scaled), ``inv_scale`` from ``LossScaler.inv_scale``:
        the finite check of the incoming values (``finite_reduce``, a
        consensus across ranks, applied to it), the unscale, and the step
        skipped where the flag is false.  Returns the flag for
        ``LossScaler.adjust``.  Without ``fused_tail`` the gradients are
        unscaled in place first (JAX's ``scaler.unscale`` then ``step``,
        bit for bit); with it the unscale folds into the step's one read
        and the gradients stay scaled."""
        name = type(self).__name__
        with torch.profiler.record_function(
                f"Optimizer.step_scaled#{name}.step_scaled"):
            finite = self._step(inv_scale=inv_scale,
                                finite_reduce=finite_reduce)
        if finite is None:
            dev = inv_scale.device
            finite = torch.ones((), dtype=torch.bool, device=dev)
        return finite

    # -- helpers of the subclasses ----------------------------------------
    def _step_rows(self, kernel, items) -> mt.StepRows:
        """The cached operand table of ``items`` (``(group, p, state)``),
        made once for a set of parameters."""
        key = (kernel,) + tuple(id(p) for _, p, _ in items)
        rows = self._rows.get(key)
        if rows is None:
            rows = mt.step_rows(
                [p for _, p, _ in items],
                [s["master"] for _, _, s in items] if self.master_weights
                else None,
                [s["exp_avg"] for _, _, s in items],
                [s["exp_avg_sq"] for _, _, s in items], kernel)
            self._rows[key] = rows
        return rows

    @staticmethod
    def _bias_corrections(group, new_step):
        """``(1 - b1**step, 1 - b2**step)`` as fp32 device scalars, or
        ``(None, None)`` without ``bias_correction``."""
        if not group.get("bias_correction", True):
            return None, None
        stepf = new_step.to(torch.float32)
        b1, b2 = group["betas"]
        return (1.0 - torch.pow(f32(b1), stepf),
                1.0 - torch.pow(f32(b2), stepf))

    @staticmethod
    def _groups(entries):
        """``entries`` split by parameter group, in order."""
        out: List[Tuple[dict, list]] = []
        for item in entries:
            if out and out[-1][0] is item[0]:
                out[-1][1].append(item)
            else:
                out.append((item[0], [item]))
        return out
