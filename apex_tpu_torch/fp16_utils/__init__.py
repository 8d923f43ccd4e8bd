"""Manual mixed precision: the legacy ``fp16_utils`` workflow.

Counterpart of ``apex_tpu/fp16_utils/__init__.py`` (after Apex's
``apex/fp16_utils``: ``fp16util.py`` and ``fp16_optimizer.py``): cast the
network, keep fp32 masters, scale the loss, unscale (and clip) the master
gradients, skip the step on an overflow.

- :func:`network_to_half` / :func:`convert_network` cast a module (in
  place) or a tree of tensors (nested dicts, lists, tuples: a new tree),
  :func:`convert_network` keeping norm parameters fp32
  (:func:`~apex_tpu_torch.amp.policy.is_norm_param` on the name path);
- :func:`prep_param_lists` gives ``(model params, fp32 master copies)``;
- :func:`model_grads_to_master_grads` and
  :func:`master_params_to_model_params` convert between the two;
- :class:`FP16_Optimizer` wraps one of the port's optimizers built over
  the model's parameters: it keeps fp32 masters, steps the optimizer on
  them with the :class:`~apex_tpu_torch.amp.scaler.LossScaler`'s unscaled
  fp32 gradients, skips the step where they are not finite, and copies
  the masters back into the model.  JAX's is a pure ``(state, grads,
  params)`` function; this one updates in place, as Apex's does, with the
  same arithmetic and no host synchronisation in a step.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch.amp.policy import is_norm_param
from apex_tpu_torch.amp.scaler import LossScaler

__all__ = [
    "network_to_half",
    "convert_network",
    "prep_param_lists",
    "model_grads_to_master_grads",
    "master_params_to_model_params",
    "FP16_Optimizer",
]


def _walk(tree: Any, fn: Callable[[tuple, torch.Tensor], Any],
          path: tuple = ()) -> Any:
    """``fn(path, tensor)`` on every tensor of nested dicts, lists and
    tuples, as a new tree."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return type(tree)((k, _walk(v, fn, path + (k,)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_walk(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def convert_network(network: Any, dtype: torch.dtype = torch.float16,
                    keep_fp32: Callable = is_norm_param) -> Any:
    """Cast the floating parameters (and buffers) of a module in place,
    or the floating tensors of a tree into a new tree, to ``dtype``, but
    those whose name path satisfies ``keep_fp32`` (norm parameters by
    default) and, in a module, those of a normalisation module (a class
    whose name has "Norm", as Apex keeps BatchNorm's), which stay as they
    are.  Returns the module or the tree."""
    if isinstance(network, nn.Module):
        with torch.no_grad():
            for mname, mod in network.named_modules():
                norm = "norm" in type(mod).__name__.lower()
                for name, t in list(mod.named_parameters(recurse=False)) \
                        + list(mod.named_buffers(recurse=False)):
                    full = f"{mname}.{name}" if mname else name
                    if t.is_floating_point() and not norm and \
                            not keep_fp32(full, t):
                        t.data = t.data.to(dtype)
        return network
    return _walk(network, lambda path, t: t if (
        not t.is_floating_point() or keep_fp32(path, t)) else t.to(dtype))


def network_to_half(network: Any, dtype: torch.dtype = torch.float16) -> Any:
    """Cast every floating parameter and buffer of a module (in place), or
    every floating tensor of a tree (a new tree), to ``dtype``."""
    if isinstance(network, nn.Module):
        return network.to(dtype)
    return convert_network(network, dtype, keep_fp32=lambda *_: False)


def prep_param_lists(params: Any) -> Tuple[Any, Any]:
    """``(params, masters)``: the model's parameters as given (a module's
    ``parameters()``, a list or a tree) and fp32 copies of them, detached
    leaves that require grad where the parameter does."""
    if isinstance(params, nn.Module):
        params = list(params.parameters())
    elif not isinstance(params, (dict, list, tuple, torch.Tensor)):
        params = list(params)

    def master(_, p):
        m = p.detach().to(torch.float32, copy=True)
        return m.requires_grad_(p.requires_grad)

    return params, _walk(params, master)


def model_grads_to_master_grads(model_grads: Any) -> Any:
    """The gradients in fp32 (a new tree; None stays None)."""
    return _walk(model_grads, lambda _, g: g.float())


def master_params_to_model_params(model_params: Any, master: Any) -> Any:
    """The masters cast to each model parameter's dtype (a new tree)."""
    models = {}
    _walk(model_params, lambda path, p: models.__setitem__(path, p.dtype))
    return _walk(master, lambda path, m: m.to(models[path]))


class FP16_Optimizer:
    """Master weights and loss scaling around one of the port's
    optimizers.

        opt = FP16_Optimizer(FusedAdam(model.parameters(), lr=1e-3),
                             dynamic_loss_scale=True)
        opt.zero_grad()
        opt.backward(loss)        # the scaled loss's backward
        finite = opt.step()       # a device bool; skipped where false

    ``optimizer`` is built over the model's (fp16) parameters and keeps no
    masters of its own; its parameter groups are pointed at fp32 masters
    here, before its first step.  ``dynamic_loss_args`` go to the
    :class:`~apex_tpu_torch.amp.scaler.LossScaler`."""

    def __init__(self, optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False):
        if getattr(optimizer, "master_weights", False):
            raise ValueError("FP16_Optimizer keeps the masters: build the "
                             "optimizer with master_weights=False")
        self.optimizer = optimizer
        self.loss_scaler = LossScaler(
            loss_scale="dynamic" if dynamic_loss_scale else static_loss_scale,
            **dict(dynamic_loss_args or {}))
        self.model_params: List[torch.Tensor] = [
            p for g in optimizer.param_groups for p in g["params"]]
        _, self.master_params = prep_param_lists(self.model_params)
        masters = iter(self.master_params)
        for g in optimizer.param_groups:
            g["params"] = [next(masters) for _ in g["params"]]
        self.scaler_state = self.loss_scaler.init(
            self.model_params[0].device)

    @property
    def loss_scale(self) -> torch.Tensor:
        return self.scaler_state.loss_scale

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.model_params + self.master_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self.loss_scaler.scale(self.scaler_state, loss)

    def backward(self, loss: torch.Tensor) -> None:
        self.scale_loss(loss).backward()

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """The model's gradients to fp32 master gradients, the unscale and
        the overflow check, the scaler's growth or backoff, the step on
        the masters (skipped where the flag is false) and the masters back
        into the model's parameters.  Returns the flag."""
        for p, m in zip(self.model_params, self.master_params):
            m.grad = None if p.grad is None else p.grad.float()
        grads = [m.grad for m in self.master_params if m.grad is not None]
        _, finite = self.loss_scaler.unscale(self.scaler_state, grads)
        self.scaler_state = self.loss_scaler.adjust(self.scaler_state,
                                                    finite)
        self.optimizer.step(grads_finite=finite)
        for p, m in zip(self.model_params, self.master_params):
            p.copy_(torch.where(finite, m.to(p.dtype), p))
        return finite

    def clip_master_grads(self, grads: Sequence[torch.Tensor],
                          max_norm: float) -> List[torch.Tensor]:
        """``grads`` scaled by ``min(1, max_norm / |grads|)``, the global
        fp32 norm (one device): new tensors."""
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
        clip = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return [g * clip.to(g.dtype) for g in grads]

    def state_dict(self) -> dict:
        """The fp32 masters, the optimizer's state and the scaler's."""
        return {"master": [m.detach().cpu() for m in self.master_params],
                "opt": self.optimizer.state_dict(),
                "scaler": self.loss_scaler.state_dict(self.scaler_state)}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        for m, saved in zip(self.master_params, d["master"]):
            m.copy_(saved)
        for p, m in zip(self.model_params, self.master_params):
            p.copy_(m.to(p.dtype))
        self.optimizer.load_state_dict(d["opt"])
        self.scaler_state = self.loss_scaler.load_state_dict(
            d["scaler"], self.model_params[0].device)

