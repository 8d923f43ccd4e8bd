"""apex_tpu_torch.amp: the opt levels, the loss scaler and
:class:`MixedPrecision`.

Counterpart of ``apex_tpu/amp/__init__.py``:

    mp = amp.initialize(opt_level="O5", loss_scale="dynamic")
    state = mp.init(device)                       # AmpState
    mp.scale_loss(state, loss).backward()
    grads, finite, state = mp.unscale_and_adjust(state, grads)
    optimizer.step(grads_finite=finite)           # skipped on overflow

or, with the unscale folded into the optimizer's read of the gradients,
``finite = optimizer.step_scaled(mp.scaler.inv_scale(s))`` then
``mp.scaler.adjust(s, finite)``.  Every state is device tensors; nothing
in a step reads them back.

Every opt level trains, O1-O3 in fp16 (``check_ported``).  The cast
decorators (``half_function``, ``float_function``, ``promote_function``,
the ``register_*`` forms and ``set_low_precision_dtype``, from
:mod:`apex_tpu_torch.amp.functional`) and the cast lists over ``torch``
and ``torch.nn.functional`` (``cast_namespaces``, and ``patch``, Apex's
O1 patch with a ``restore``, from :mod:`apex_tpu_torch.amp.lists`) are
re-exported here, as in JAX.  ``StepGuard`` and ``DivergenceError`` are
re-exported lazily from :mod:`apex_tpu_torch.resilience.guard`.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from apex_tpu_torch.amp.functional import (
    bfloat16_function,
    float_function,
    half_function,
    promote_function,
    register_float_function,
    register_half_function,
    register_promote_function,
    set_low_precision_dtype,
)
from apex_tpu_torch.amp.lists import (
    FP32_NN,
    FP32_NUMPY,
    LOW_PRECISION_LAX,
    LOW_PRECISION_NUMPY,
    PROMOTE_NUMPY,
    SEQUENCE_NUMPY,
    cast_namespaces,
    patch,
)
from apex_tpu_torch.amp.policy import (
    OPT_LEVELS,
    Policy,
    check_ported,
    get_policy,
    is_norm_param,
    tree_cast,
)
from apex_tpu_torch.amp.scaler import (
    LossScaler,
    ScalerState,
    all_finite,
    scale_gradients,
)

__all__ = [
    "OPT_LEVELS", "Policy", "check_ported", "get_policy",
    "is_norm_param", "tree_cast", "LossScaler", "ScalerState", "all_finite",
    "scale_gradients", "AmpState", "MixedPrecision", "initialize",
    "StepGuard", "DivergenceError",
    "FP32_NN", "FP32_NUMPY", "LOW_PRECISION_LAX", "LOW_PRECISION_NUMPY",
    "PROMOTE_NUMPY", "SEQUENCE_NUMPY", "cast_namespaces", "patch",
    "bfloat16_function", "float_function", "half_function",
    "promote_function", "register_float_function",
    "register_half_function", "register_promote_function",
    "set_low_precision_dtype",
]


def __getattr__(name):
    # the guard's inputs are amp's outputs (the finite flag, the scaler
    # state); resolved lazily, as in JAX
    if name in ("StepGuard", "DivergenceError"):
        from apex_tpu_torch.resilience import guard

        val = getattr(guard, name)
        globals()[name] = val
        return val
    raise AttributeError(
        f"module 'apex_tpu_torch.amp' has no attribute {name!r}")


class AmpState(NamedTuple):
    """One :class:`ScalerState` a loss."""

    scaler_states: Tuple[ScalerState, ...]


class MixedPrecision:
    """A :class:`Policy` with a :class:`LossScaler` for each of
    ``num_losses`` losses."""

    def __init__(self, policy: Policy, num_losses: int = 1, **scaler_kwargs):
        self.policy = policy
        self.num_losses = num_losses
        self.scaler = LossScaler(loss_scale=policy.loss_scale,
                                 **scaler_kwargs)

    # -- lifecycle -------------------------------------------------------
    def init(self, params: Any = None,
             device: Union[str, torch.device, None] = None):
        """Fresh scaler states on ``device`` (the GPU by default; the
        device of the first tensor of ``params`` when there is one), and
        with ``params`` (a tree of tensors) those cast per the policy:
        ``(cast_params, AmpState)``, else just the state."""
        if device is None and params is not None:
            device = _first_device(params)
        state = AmpState(tuple(self.scaler.init(device)
                               for _ in range(self.num_losses)))
        if params is None:
            return state
        return self.policy.cast_to_param(params), state

    # -- loss scaling ----------------------------------------------------
    def scale_loss(self, state: AmpState, loss: torch.Tensor,
                   loss_id: int = 0) -> torch.Tensor:
        return self.scaler.scale(state.scaler_states[loss_id], loss)

    def unscale_and_adjust(self, state: AmpState, grads, loss_id: int = 0,
                           finite_reduce=None):
        """Unscale ``grads`` in place, then adjust the loss's scaler with
        the finite flag (passed through ``finite_reduce``, a consensus
        across ranks such as ``transformer.amp.model_parallel_all_finite``,
        first).  ``(grads, finite, new_state)``."""
        sstate = state.scaler_states[loss_id]
        grads, finite = self.scaler.unscale(sstate, grads)
        if finite_reduce is not None:
            finite = finite_reduce(finite)
        states = list(state.scaler_states)
        states[loss_id] = self.scaler.adjust(sstate, finite)
        return grads, finite, AmpState(tuple(states))

    @staticmethod
    def apply_if_finite(finite: torch.Tensor, old_tree: Any,
                        new_tree: Any) -> Any:
        """``new_tree`` where ``finite``, else ``old_tree``, leaf by leaf
        (nested dicts, lists, tuples of tensors)."""
        if isinstance(new_tree, dict):
            return type(new_tree)(
                (k, MixedPrecision.apply_if_finite(finite, old_tree[k], v))
                for k, v in new_tree.items())
        if isinstance(new_tree, (list, tuple)) and \
                not hasattr(new_tree, "_fields"):
            return type(new_tree)(
                MixedPrecision.apply_if_finite(finite, o, n)
                for o, n in zip(old_tree, new_tree))
        return torch.where(finite, new_tree, old_tree)

    # -- master weights --------------------------------------------------
    def make_master(self, params: Any) -> Any:
        """fp32 masters of a tree."""
        return self.policy.cast_to_master(params)

    def master_to_model(self, master: Any) -> Any:
        """Masters cast back to the model's precision."""
        return self.policy.cast_to_param(master)

    # -- checkpointing ---------------------------------------------------
    def state_dict(self, state: AmpState) -> dict:
        return {f"loss_scaler{i}": self.scaler.state_dict(s)
                for i, s in enumerate(state.scaler_states)}

    def load_state_dict(self, d: dict,
                        device: Union[str, torch.device, None] = None
                        ) -> AmpState:
        return AmpState(tuple(
            self.scaler.load_state_dict(d[f"loss_scaler{i}"], device)
            for i in range(self.num_losses)))


def _first_device(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for node in tree:
            dev = _first_device(node)
            if dev is not None:
                return dev
    return None


_SCALER_KEYS = ("init_scale", "growth_factor", "backoff_factor",
                "growth_interval", "max_loss_scale", "min_loss_scale")


def initialize(opt_level: str = "O5", num_losses: int = 1,
               **overrides) -> MixedPrecision:
    """A :class:`MixedPrecision` from an opt level and overrides: the
    scaler's keywords (``init_scale``, ``growth_factor``,
    ``backoff_factor``, ``growth_interval``, ``max_loss_scale``,
    ``min_loss_scale``) go to its :class:`LossScaler`, the rest override
    the preset :class:`Policy` (``loss_scale="dynamic"`` on O5, say).
    The trainers refuse a policy whose kernels are not ported with
    :func:`check_ported`; the scaler itself runs for any."""
    scaler_kwargs = {k: overrides.pop(k) for k in list(overrides)
                     if k in _SCALER_KEYS}
    policy = get_policy(opt_level, **overrides)
    return MixedPrecision(policy, num_losses=num_losses, **scaler_kwargs)
