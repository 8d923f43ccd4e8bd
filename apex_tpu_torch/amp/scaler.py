"""Loss scaling with the overflow skip-step, as device state.

Counterpart of ``apex_tpu/amp/scaler.py``: the scaler's state is a
:class:`ScalerState` of 0-d device tensors (an fp32 scale and two int32
counters), and every operation returns a new state without reading it
back to the host, so a training step never synchronises:

    scaler = LossScaler()                       # config
    state = scaler.init(device)                 # ScalerState
    scaler.scale(state, loss).backward()
    grads, finite = scaler.unscale(state, grads)     # in place
    state = scaler.adjust(state, finite)        # growth / backoff
    optimizer.step(grads_finite=finite)         # skipped on overflow

The schedule is the JAX one, step for step: init 2**16, double after
``growth_interval`` finite steps in a row, halve on an overflow, clamped
to ``[min_loss_scale, max_loss_scale]``.  :meth:`LossScaler.state_dict` is
the one host read, as in JAX.

On the card :func:`all_finite` and :meth:`LossScaler.unscale` launch the
``multi_tensor_scale`` kernel (``ops/multi_tensor.py``): one read of every
gradient, the check of the incoming (still scaled) values and the
multiply in the same pass.  Unlike JAX, whose arrays are immutable,
:meth:`LossScaler.unscale` multiplies the gradients in place, as
``torch.cuda.amp.GradScaler.unscale_`` does; :func:`scale_gradients`
returns new tensors, as JAX's does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops import multi_tensor as mt

__all__ = ["ScalerState", "LossScaler", "all_finite", "scale_gradients"]


class ScalerState(NamedTuple):
    """The scaler's state: the fp32 loss scale, the int32 count of finite
    steps since the last growth, and the int32 count of finite steps."""

    loss_scale: torch.Tensor
    growth_tracker: torch.Tensor
    unskipped: torch.Tensor


def _floats(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [t for t in tensors if t is not None and t.is_floating_point()]


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """True (a 0-d bool device tensor) iff every element of every floating
    tensor is finite: the reference's overflow flag, one kernel launch
    over the list on the card."""
    leaves = _floats(tensors)
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    return mt.scale(leaves)


def scale_gradients(tensors: Sequence[torch.Tensor],
                    scale: Union[float, torch.Tensor]) -> List[torch.Tensor]:
    """New tensors ``(g.float() * scale)`` rounded to each ``g``'s dtype;
    non-floating entries pass through."""
    out = [torch.empty_like(t) if t is not None and t.is_floating_point()
           else t for t in tensors]
    leaves = [i for i, t in enumerate(tensors)
              if t is not None and t.is_floating_point()]
    if leaves:
        mt.scale([tensors[i] for i in leaves], scale,
                 out=[out[i] for i in leaves])
    return out


class LossScaler:
    """A static or dynamic loss scaler over :class:`ScalerState`.

    ``loss_scale="dynamic"`` grows and backs off; a float scales by that
    constant (growth off); None or 1.0 passes through (the bf16 levels
    O4/O5 keep no scaler at all)."""

    def __init__(
        self,
        loss_scale: Optional[Union[float, str]] = "dynamic",
        init_scale: float = 2.0 ** 16,
        growth_factor: float = 2.0,
        backoff_factor: float = 0.5,
        growth_interval: int = 2000,
        max_loss_scale: float = 2.0 ** 24,
        min_loss_scale: Optional[float] = None,
    ):
        self.dynamic = loss_scale == "dynamic"
        if loss_scale is None:
            self._static_scale = 1.0
        elif self.dynamic:
            self._static_scale = init_scale
        else:
            self._static_scale = float(loss_scale)
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.max_loss_scale = max_loss_scale
        self.min_loss_scale = (min_loss_scale if min_loss_scale is not None
                               else 1.0)

    # -- state -----------------------------------------------------------
    def init(self, device: Union[str, torch.device, None] = None
             ) -> ScalerState:
        """A fresh state on ``device`` (the GPU by default)."""
        from apex_tpu_torch.utils.platform import resolve_device

        dev = resolve_device(device)
        return ScalerState(
            torch.full((), self._static_scale, dtype=torch.float32,
                       device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))

    # -- the step's operations (no host synchronisation) -----------------
    def scale(self, state: ScalerState, loss: torch.Tensor) -> torch.Tensor:
        """``loss.float() * loss_scale``."""
        return loss.float() * state.loss_scale

    def inv_scale(self, state: ScalerState) -> torch.Tensor:
        """``1 / loss_scale``, the multiplier that
        :meth:`~apex_tpu_torch.optimizers.base.FusedOptimizer.step_scaled`
        folds into the optimizer's read of the gradients."""
        return torch.reciprocal(state.loss_scale)

    def unscale(self, state: ScalerState, grads: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Multiply the floating ``grads`` by ``1 / loss_scale`` in place
        (rounded to each one's dtype) and report whether every incoming
        value was finite.  Non-finite gradients are multiplied too: the
        caller skips the step with the flag."""
        grads = list(grads)
        leaves = _floats(grads)
        if not leaves:
            return grads, torch.ones((), dtype=torch.bool,
                                     device=state.loss_scale.device)
        finite = mt.scale(leaves, self.inv_scale(state), out=leaves)
        return grads, finite

    def adjust(self, state: ScalerState,
               grads_finite: torch.Tensor) -> ScalerState:
        """The next state after a step whose gradients were (not) finite:
        the dynamic growth and backoff, and the count of finite steps."""
        unskipped = state.unskipped + grads_finite.to(torch.int32)
        if not self.dynamic:
            return ScalerState(state.loss_scale, state.growth_tracker,
                               unskipped)
        tracker = torch.where(grads_finite, state.growth_tracker + 1,
                              torch.zeros_like(state.growth_tracker))
        grown = tracker >= self.growth_interval
        scale = state.loss_scale
        up = torch.where(
            grown, torch.clamp(scale * self.growth_factor,
                               max=self.max_loss_scale), scale)
        down = torch.clamp(scale * self.backoff_factor,
                           min=self.min_loss_scale)
        return ScalerState(
            torch.where(grads_finite, up, down).to(torch.float32),
            torch.where(grown, torch.zeros_like(tracker),
                        tracker).to(torch.int32),
            unskipped)

    def unscale_and_adjust(self, state: ScalerState,
                           grads: Sequence[torch.Tensor]):
        """:meth:`unscale` then :meth:`adjust`: ``(grads, finite,
        new_state)``."""
        grads, finite = self.unscale(state, grads)
        return grads, finite, self.adjust(state, finite)

    # -- checkpointing ---------------------------------------------------
    def state_dict(self, state: ScalerState) -> dict:
        """The state as host numbers: the one read of the device here."""
        return {
            "loss_scale": float(state.loss_scale),
            "growth_tracker": int(state.growth_tracker),
            "unskipped": int(state.unskipped),
        }

    def load_state_dict(self, d: dict,
                        device: Union[str, torch.device, None] = None
                        ) -> ScalerState:
        """A state from :meth:`state_dict`'s numbers, on ``device`` (the
        GPU by default)."""
        from apex_tpu_torch.utils.platform import resolve_device

        dev = resolve_device(device)
        return ScalerState(
            torch.tensor(float(d["loss_scale"]), dtype=torch.float32,
                         device=dev),
            torch.tensor(int(d["growth_tracker"]), dtype=torch.int32,
                         device=dev),
            torch.tensor(int(d["unskipped"]), dtype=torch.int32, device=dev))
