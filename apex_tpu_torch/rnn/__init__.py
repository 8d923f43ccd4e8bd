"""The RNN stack: the counterpart of ``apex_tpu/rnn``.

Tanh, ReLU, LSTM, GRU and multiplicative-LSTM cells, and the stacked
(optionally bidirectional) container, on ``(seq, batch, features)``.
JAX drives each cell's ``(carry, x) -> (carry, y)`` step with
``lax.scan``; the port loops over time in Python and lets autograd take
the backward.  The functions are JAX's, which are not ``nn.LSTM``'s or
``nn.GRU``'s, so cuDNN's RNN does not compute them and the steps are
plain ``torch.matmul`` products (cuBLAS on the card):

- gates ``x @ w_ih + h @ w_hh + bias`` (weights ``(in, gates * h)``),
  split in the order ``(i, f, g, o)`` for the LSTMs;
- the LSTM's forget-gate bias filled with ``forget_bias`` at init;
- the GRU's one bias, on the input gates only (``nn.GRU`` has a second,
  ``b_hn``, inside the reset product);
- the mLSTM's ``m = (x @ w_mih) * (h @ w_mhh)`` standing in for ``h`` in
  the gates.

A cell's parameters are its own (``w_ih``, ``w_hh``, ``bias``, ``w_mih``,
``w_mhh``, as JAX names them), and a :class:`StackedRNN`'s cells are its
children ``"0"``, ``"1"``, ..., so the state dict names ``0.w_ih`` as
JAX's list of cell dicts flattens.  ``key`` (a port PRNG key) draws them
as JAX's ``init(key)`` does; ``device`` defaults to the GPU.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import random as prng
from apex_tpu_torch.mlp import uniform
from apex_tpu_torch.ops.dropout import dropout
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "RNNCell", "StackedRNN"]


class RNNCell(nn.Module):
    """One recurrent cell: gates ``x @ w_ih + h @ w_hh + bias``, split
    into ``gate_multiplier`` chunks; :meth:`step` is the cell's update."""

    gate_multiplier = 1
    n_hidden_states = 1  # h (the LSTMs add c)

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True,
                 forget_bias: float = 1.0,
                 params_dtype: torch.dtype = torch.float32, *, device=None,
                 key=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.use_bias = bias
        self.forget_bias = forget_bias
        self.params_dtype = params_dtype
        self._init(prng.PRNGKey(0) if key is None else key,
                   resolve_device(device))

    def _init(self, key, dev) -> None:
        g, h, i = self.gate_multiplier, self.hidden_size, self.input_size
        k1, k2, _ = prng.split(key, 3)
        bound = 1.0 / math.sqrt(h)
        self.w_ih = nn.Parameter(uniform(k1, (i, g * h), bound,
                                         self.params_dtype, dev))
        self.w_hh = nn.Parameter(uniform(k2, (h, g * h), bound,
                                         self.params_dtype, dev))
        self.register_parameter("bias", None)
        if self.use_bias:
            b = torch.zeros(g * h, dtype=self.params_dtype, device=dev)
            self.bias = nn.Parameter(self._init_bias(b))

    def _init_bias(self, b: torch.Tensor) -> torch.Tensor:
        return b

    def init_carry(self, batch: int, dtype=None, device=None) -> Any:
        h = torch.zeros(batch, self.hidden_size,
                        dtype=dtype or self.params_dtype,
                        device=device or self.w_ih.device)
        return (h, h) if self.n_hidden_states == 2 else h

    def _gates(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        g = (torch.matmul(x, self.w_ih.to(x.dtype))
             + torch.matmul(h, self.w_hh.to(x.dtype)))
        if self.bias is not None:
            g = g + self.bias.to(g.dtype)
        return g

    def step(self, carry, x: torch.Tensor):
        raise NotImplementedError

    def forward(self, xs: torch.Tensor,
                carry: Optional[Any] = None) -> Tuple[Any, torch.Tensor]:
        """Run over ``xs (seq, batch, in)``; returns ``(final carry, ys
        (seq, batch, hidden))``."""
        if carry is None:
            carry = self.init_carry(xs.shape[1], xs.dtype, xs.device)
        ys = []
        for x in xs.unbind(0):
            carry, y = self.step(carry, x)
            ys.append(y)
        return carry, torch.stack(ys)


class _TanhCell(RNNCell):
    def step(self, carry, x):
        h = torch.tanh(self._gates(carry, x))
        return h, h


class _ReLUCell(RNNCell):
    def step(self, carry, x):
        h = F.relu(self._gates(carry, x))
        return h, h


def _lstm_update(g: torch.Tensor, c_prev: torch.Tensor):
    i, f, cand, o = torch.chunk(g, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(cand)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


class _LSTMCell(RNNCell):
    gate_multiplier = 4
    n_hidden_states = 2

    def _init_bias(self, b):
        # the forget gate's bias, gates in the order (i, f, g, o)
        h = self.hidden_size
        b[h:2 * h] = self.forget_bias
        return b

    def step(self, carry, x):
        h_prev, c_prev = carry
        return _lstm_update(self._gates(h_prev, x), c_prev)


class _GRUCell(RNNCell):
    gate_multiplier = 3

    def step(self, carry, x):
        gi = torch.matmul(x, self.w_ih.to(x.dtype))
        gh = torch.matmul(carry, self.w_hh.to(x.dtype))
        if self.bias is not None:
            gi = gi + self.bias.to(gi.dtype)
        ir, iz, in_ = torch.chunk(gi, 3, dim=-1)
        hr, hz, hn = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        h = (1.0 - z) * n + z * carry
        return h, h


class _mLSTMCell(_LSTMCell):
    """Multiplicative LSTM: ``m = (x @ w_mih) * (h @ w_mhh)`` takes ``h``'s
    place in the gates."""

    def _init(self, key, dev) -> None:
        k1, k2, k3 = prng.split(key, 3)
        super()._init(k1, dev)
        h, i = self.hidden_size, self.input_size
        bound = 1.0 / math.sqrt(h)
        self.w_mih = nn.Parameter(uniform(k2, (i, h), bound,
                                          self.params_dtype, dev))
        self.w_mhh = nn.Parameter(uniform(k3, (h, h), bound,
                                          self.params_dtype, dev))

    def step(self, carry, x):
        h_prev, c_prev = carry
        m = (torch.matmul(x, self.w_mih.to(x.dtype))
             * torch.matmul(h_prev, self.w_mhh.to(x.dtype)))
        return _lstm_update(self._gates(m, x), c_prev)


class StackedRNN(nn.Module):
    """Stacked, optionally bidirectional cells.  ``cell_factory(in_size,
    hidden_size, device=, key=)`` makes each cell; with ``dropout`` and a
    ``rng`` key, the outputs of every layer but the last go through
    :func:`apex_tpu_torch.ops.dropout.dropout` with JAX's mask (a key
    split off ``rng`` a layer)."""

    def __init__(self, cell_factory: Callable[..., RNNCell], input_size: int,
                 hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0, *,
                 device=None, key=None):
        super().__init__()
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dropout = dropout
        d = 2 if bidirectional else 1
        dev = resolve_device(device)
        keys = prng.split(prng.PRNGKey(0) if key is None else key,
                          num_layers * d)
        for n in range(num_layers * d):
            in_size = input_size if n < d else hidden_size * d
            self.add_module(str(n), cell_factory(in_size, hidden_size,
                                                 device=dev, key=keys[n]))

    def forward(self, xs: torch.Tensor, rng=None) -> torch.Tensor:
        cells = list(self.children())
        h = xs
        step = 2 if self.bidirectional else 1
        for layer in range(self.num_layers):
            _, fwd = cells[layer * step](h)
            if self.bidirectional:
                _, bwd = cells[layer * step + 1](h.flip(0))
                h = torch.cat([fwd, bwd.flip(0)], dim=-1)
            else:
                h = fwd
            if (self.dropout > 0.0 and rng is not None
                    and layer < self.num_layers - 1):
                rng, sub = prng.split(rng)
                h = dropout(h, sub, self.dropout)
        return h


def _model(cell_cls):
    def factory(input_size: int, hidden_size: int, num_layers: int = 1,
                bidirectional: bool = False, dropout: float = 0.0, *,
                device=None, key=None, **cell_kw) -> StackedRNN:
        return StackedRNN(
            lambda i, h, **kw: cell_cls(i, h, **cell_kw, **kw),
            input_size, hidden_size, num_layers, bidirectional, dropout,
            device=device, key=key)

    return factory


LSTM = _model(_LSTMCell)
GRU = _model(_GRUCell)
Tanh = _model(_TanhCell)
ReLU = _model(_ReLUCell)
mLSTM = _model(_mLSTMCell)
