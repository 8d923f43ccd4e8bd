"""Multi-tensor kernels of the optimizer tail: scale (and axpby), the L2
norms, Adam and LAMB (``csrc/multi_tensor.cu``), their plain versions, and
the wrappers that pick by the tensors' device.

They replace no Pallas kernel: the JAX package runs the tail in XLA
(``apex_tpu/multi_tensor_apply``, ``optimizers/fused_adam.py``,
``optimizers/fused_lamb.py``), where a jitted update over the parameter
tree compiles to a few fused loops.  Eager PyTorch has no such fusion: the
port's tail was a dozen launches per parameter tensor from a Python loop.
These are the reference's ``amp_C`` kernels, one launch over a list of
tensors:

- :func:`scale`: ``out = a * x`` (or ``a * x + b * y``) rounded to the
  output's dtype, in place or not, and the finite flag of the incoming
  values; with no output, the flag alone (``all_finite``);
- :func:`l2norm`: each tensor's fp32 sum of squares, their sum in tensor
  order and one sqrt (optionally each tensor's norm), and the finite flag;
  with ``inv_scale`` the values are unscaled first, rounded through their
  dtype;
- :func:`adam`: the whole Adam update of a list, one pass over each
  element (unscale, clip, decay, moments, bias corrections, the fp32
  master and the model-dtype parameter);
- :func:`lamb`: LAMB in two stages (moments and the update into fp32
  scratch with each tensor's norms, then the trust-scaled step).

Every function takes a finite flag (a 0-d bool tensor) where it reads or
writes one; :func:`adam` and :func:`lamb` write nothing at all when it is
false, so an overflowed step leaves every state bit as it was.  The
coefficients that change each step (the bias corrections, the clip factor,
the loss scaler's ``1 / scale``) are device scalars that the caller
computes once, so the kernel and the plain version read the same values
and the step makes no host synchronisation.

On CPU tensors each function runs its plain version, whose arithmetic is
the kernel's, operation for operation: on the card, :func:`adam` without a
clip gives the plain version's bits, and :func:`scale` always does.  The
norms add in another order (chunks of 65,536 elements, then the chunks in
order), so they and what depends on them (a clip factor, LAMB's trust
ratios) agree within a few fp32 ulps.  On CUDA tensors each function
launches its kernel or raises; tensors on two devices raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from apex_tpu_torch.ops.common import (
    check,
    count_launch,
    kernel_entry,
    load,
    stream_of,
)

__all__ = [
    "CHUNK", "KERNELS", "Norms", "StepRows", "adam", "commit", "l2norm",
    "lamb", "scale", "step_rows",
]

KERNEL_SCALE = "multi_tensor_scale"
KERNEL_AXPBY = "multi_tensor_axpby"
KERNEL_L2NORM = "multi_tensor_l2norm"
KERNEL_ADAM = "multi_tensor_adam"
KERNEL_LAMB = "multi_tensor_lamb"
#: the four kernels of the optimizer tail (axpby is scale's two-input
#: instance, counted under its own name)
KERNELS = (KERNEL_SCALE, KERNEL_L2NORM, KERNEL_ADAM, KERNEL_LAMB)

#: elements a block of the kernels takes (``kChunk`` in the source)
CHUNK = 65536
#: LAMB's scratch places each tensor at a multiple of this many elements
#: (``kVec``), so its 16-byte vectors stay aligned
VEC = 8

#: the kernels' dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the second moment's storage dtypes the step kernels take
MOMENT_DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {
    "multi_tensor_scale": [_P] * 3 + [_I] * 2 + [_P] * 2 + [_F] * 2
    + [_P] * 2,
    "multi_tensor_l2norm": [_P] * 3 + [_I] + [_P] * 7,
    "multi_tensor_adam": [_P] * 3 + [_I] * 2 + [_P] * 5 + [_F] * 7 + [_I]
    + [_P],
    "multi_tensor_lamb": [_P] * 3 + [_I] * 2 + [_P] * 9 + [_F] * 7
    + [_I] * 2 + [_P],
}

Scalar = Union[float, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    """The loaded library and its C entry, typed once."""
    lib = load("multi_tensor")
    fn = getattr(lib, symbol)
    fn.argtypes = ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return lib, fn


def _device(kernel: str, *lists) -> Optional[torch.device]:
    """The one device of every tensor in ``lists`` (None entries and
    empty lists skipped); raises for two devices."""
    dev = None
    for lst in lists:
        for t in lst or ():
            if t is None:
                continue
            if dev is None:
                dev = t.device
            elif t.device != dev:
                raise ValueError(f"{kernel}: tensors on {dev} and {t.device}")
    return dev


def _code(kernel: str, t: torch.Tensor) -> int:
    code = _DTYPES.get(t.dtype)
    if code is None:
        raise ValueError(f"{kernel}: dtype {t.dtype} is not one of "
                         f"{list(_DTYPES)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: operand of shape {tuple(t.shape)} is "
                         "not contiguous")
    return code


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _scalar_ptr(kernel: str, x, dev) -> Optional[int]:
    """A device fp32 0-d tensor's pointer (None for None)."""
    if x is None:
        return None
    if x.dtype != torch.float32 or x.numel() != 1 or x.device != dev:
        raise ValueError(f"{kernel}: a scalar operand must be one fp32 "
                         f"element on {dev}, got {x.dtype} on {x.device}")
    return x.data_ptr()


def _flag_ptr(kernel: str, finite, dev) -> Optional[int]:
    if finite is None:
        return None
    if finite.dtype != torch.bool or finite.numel() != 1 or \
            finite.device != dev:
        raise ValueError(f"{kernel}: the finite flag must be one bool on "
                         f"{dev}, got {finite.dtype} on {finite.device}")
    return finite.data_ptr()


def _arr(values, dtype=np.int64) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(values, dtype=dtype))


def _new_flag(dev) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=dev)


# ------------------------------------------------------------------- cost
def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts or ())


def scale_cost(xs, ys, out):
    """``multi_tensor_scale``'s (``_axpby``'s) ``(operations, bytes)`` as
    PERF.md's bound column counts them: every input read and output
    written once; two operations an element (four with ``ys``)."""
    n = sum(x.numel() for x in xs)
    return float((2 if ys is None else 4) * n), float(
        _nbytes(xs) + _nbytes(ys) + _nbytes(out))


def l2norm_cost(xs):
    """``multi_tensor_l2norm``'s: every value read once; two operations
    an element."""
    return 2.0 * sum(x.numel() for x in xs), float(_nbytes(xs))


def _scale_costs(xs, a=1.0, *, out=None, ys=None, b=0.0, finite=None):
    """:func:`scale`'s entry costs: none when no value is there."""
    if any(x.numel() for x in xs):
        yield (KERNEL_SCALE if ys is None else KERNEL_AXPBY,
               scale_cost(xs, ys, out))


def _l2norm_costs(xs, **_):
    """:func:`l2norm`'s entry costs."""
    if any(x.numel() for x in xs):
        yield KERNEL_L2NORM, l2norm_cost(xs)


def _step_costs(kernel: str, ops_per_element: float):
    """The entry costs of :func:`adam` (``kernel``) or :func:`lamb`."""
    def costs(grads, rows, **_):
        if rows.sizes.any():
            yield kernel, step_cost(grads, rows, ops_per_element)
    return costs


def step_cost(grads, rows: "StepRows", ops_per_element: float):
    """An Adam or LAMB step's: each gradient read, each master and moment
    read and written (the parameter read where there is no master), each
    parameter written; ``ops_per_element`` (14 Adam, 20 LAMB)."""
    nbytes = 0
    for i, p in enumerate(rows.params):
        n = p.numel()
        nbytes += n * (grads[i].element_size() + p.element_size()
                       + 2 * rows.exp_avgs[i].element_size()
                       + 2 * rows.exp_avg_sqs[i].element_size()
                       + (8 if rows.master else p.element_size()))
    n = sum(p.numel() for p in rows.params)
    return ops_per_element * n, float(nbytes)


# ------------------------------------------------------------------ scale
def _scale_plain(xs, a, ys, b, outs, finite):
    flags = [torch.isfinite(x).all() for x in xs if x.numel()]
    flags += [torch.isfinite(y).all() for y in ys or () if y.numel()]
    if flags:
        finite &= torch.stack(flags).all()
    if outs is None:
        return
    for i, x in enumerate(xs):
        xf = x.float()
        val = a * xf if ys is None else a * xf + b * ys[i].float()
        outs[i].copy_(val.to(outs[i].dtype))


@kernel_entry(_scale_costs)
def scale(xs: Sequence[torch.Tensor], a: Scalar = 1.0, *,
          out: Optional[Sequence[torch.Tensor]] = None,
          ys: Optional[Sequence[torch.Tensor]] = None, b: Scalar = 0.0,
          finite: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[i] = a * xs[i]`` (with ``ys``: ``a * xs[i] + b * ys[i]``)
    computed in fp32 and rounded to ``out[i]``'s dtype (``out`` may be
    ``xs``: in place); without ``out`` only the check.  ``a`` and ``b``
    are floats (rounded to fp32) or fp32 0-d tensors on the device.
    Returns the finite flag of the incoming values (``finite`` ANDed
    with it, and updated in place, when given)."""
    kernel = KERNEL_SCALE if ys is None else KERNEL_AXPBY
    xs = list(xs)
    if out is not None and len(out) != len(xs) or \
            ys is not None and len(ys) != len(xs):
        raise ValueError(f"{kernel}: lists of different lengths")
    if ys is not None and out is None:
        raise ValueError(f"{kernel}: axpby needs an output list")
    dev = _device(kernel, xs, ys, out,
                  [t for t in (a, b, finite) if isinstance(t, torch.Tensor)])
    if dev is None:
        return torch.ones((), dtype=torch.bool) if finite is None else finite
    if finite is None:
        finite = _new_flag(dev)
    for i, x in enumerate(xs):
        for other in ((out[i],) if out is not None else ()) + (
                (ys[i],) if ys is not None else ()):
            if other.numel() != x.numel():
                raise ValueError(f"{kernel}: {other.numel()} elements "
                                 f"beside {x.numel()}")
    if dev.type != "cuda":
        _scale_plain(xs, a, ys, b, out, finite)
    else:
        _scale_cuda(kernel, dev, xs, a, ys, b, out, finite)
    return finite


def _scale_cuda(kernel, dev, xs, a, ys, b, out, finite) -> None:
    rows, sizes, codes = [], [], []
    for i, x in enumerate(xs):
        y = ys[i] if ys is not None else None
        o = out[i] if out is not None else None
        cx = _code(kernel, x)
        rows.append((x.data_ptr(), _ptr(y) or 0, _ptr(o) or 0))
        codes.append((cx, _code(kernel, y) if y is not None else 0,
                       _code(kernel, o) if o is not None else 0))
        sizes.append(x.numel())
    if not any(sizes):
        return
    mode = 0 if out is None else (1 if ys is None else 2)
    ptrs, sz, dt = _arr(rows), _arr(sizes), _arr(codes, np.int32)
    a_ptr = _scalar_ptr(kernel, a, dev) if isinstance(a, torch.Tensor) \
        else None
    b_ptr = _scalar_ptr(kernel, b, dev) if isinstance(b, torch.Tensor) \
        else None
    lib, fn = _entry(KERNEL_SCALE)
    with count_launch(kernel):
        err = fn(ptrs.ctypes.data, sz.ctypes.data, dt.ctypes.data, len(xs),
                 mode, a_ptr, b_ptr, 0.0 if a_ptr else float(a),
                 0.0 if b_ptr else float(b), finite.data_ptr(),
                 stream_of(xs[0]))
    check(lib, kernel, err)


# ----------------------------------------------------------------- l2norm
class Norms(NamedTuple):
    """:func:`l2norm`'s result: the global norm (fp32 0-d), each tensor's
    norm (an fp32 (n,) tensor, or None), the finite flag, and each
    tensor's sum of squares (fp32 (n,))."""

    total: torch.Tensor
    per_tensor: Optional[torch.Tensor]
    finite: torch.Tensor
    sq: Optional[torch.Tensor] = None


def _unscaled(x: torch.Tensor, inv_scale) -> torch.Tensor:
    """``x`` in fp32, unscaled through its own dtype where ``inv_scale``
    is given: ``(x * inv).astype(x.dtype).astype(f32)`` as JAX folds it."""
    xf = x.float()
    if inv_scale is None:
        return xf
    return (xf * inv_scale).to(x.dtype).float()


def _l2norm_plain(xs, inv_scale, per_tensor, finite):
    flags = [torch.isfinite(x).all() for x in xs if x.numel()]
    if flags:
        finite &= torch.stack(flags).all()
    dev = xs[0].device
    sq = [torch.sum(torch.square(_unscaled(x, inv_scale))) for x in xs]
    sq = torch.stack(sq) if sq else torch.zeros((0,), device=dev)
    total = torch.sqrt(sq.sum())
    return Norms(total, torch.sqrt(sq) if per_tensor else None, finite, sq)


@kernel_entry(_l2norm_costs)
def l2norm(xs: Sequence[torch.Tensor], *,
           inv_scale: Optional[torch.Tensor] = None,
           per_tensor: bool = False,
           finite: Optional[torch.Tensor] = None) -> Norms:
    """The fp32 L2 norm of all ``xs`` together (each tensor's sum of
    squares, their sum, one sqrt), each tensor's norm with
    ``per_tensor``, and the finite flag of the incoming values (ANDed into
    ``finite`` in place when given).  ``inv_scale`` (an fp32 0-d device
    tensor) unscales each value first, rounded through its dtype."""
    xs = list(xs)
    dev = _device(KERNEL_L2NORM, xs,
                  [t for t in (inv_scale, finite) if t is not None])
    if dev is None:
        zero = torch.zeros((), dtype=torch.float32)
        return Norms(zero, torch.zeros((0,)) if per_tensor else None,
                     torch.ones((), dtype=torch.bool) if finite is None
                     else finite, torch.zeros((0,)))
    if finite is None:
        finite = _new_flag(dev)
    if dev.type != "cuda":
        return _l2norm_plain(xs, inv_scale, per_tensor, finite)
    return _l2norm_cuda(dev, xs, inv_scale, per_tensor, finite)


def _l2norm_cuda(dev, xs, inv_scale, per_tensor, finite) -> Norms:
    sizes = [x.numel() for x in xs]
    codes = [_code(KERNEL_L2NORM, x) for x in xs]
    n = len(xs)
    sq = torch.zeros((n,), dtype=torch.float32, device=dev)
    norms = torch.zeros((n,), dtype=torch.float32, device=dev) \
        if per_tensor else None
    total = torch.zeros((), dtype=torch.float32, device=dev)
    chunks = sum(-(-s // CHUNK) for s in sizes)
    if chunks == 0:
        return Norms(total, norms, finite, sq)
    partials = torch.empty((chunks,), dtype=torch.float32, device=dev)
    ptrs, sz, dt = _arr([x.data_ptr() for x in xs]), _arr(sizes), \
        _arr(codes, np.int32)
    lib, fn = _entry(KERNEL_L2NORM)
    with count_launch(KERNEL_L2NORM):
        err = fn(ptrs.ctypes.data, sz.ctypes.data, dt.ctypes.data, n,
                 _scalar_ptr(KERNEL_L2NORM, inv_scale, dev),
                 partials.data_ptr(), sq.data_ptr(), _ptr(norms),
                 total.data_ptr(), finite.data_ptr(), stream_of(xs[0]))
    check(lib, KERNEL_L2NORM, err)
    return Norms(total, norms, finite, sq)


# ------------------------------------------------------------------- steps
class StepRows:
    """The operands of a step kernel that stay put from step to step: each
    row's parameter, fp32 master (or none), exp_avg and exp_avg_sq
    pointers, its size and dtypes.  The gradients' column is filled at
    each call (``zero_grad(set_to_none=True)`` frees them).  The pointer
    table :attr:`ptrs` is built when a launch first reads it: the plain
    version needs none."""

    def __init__(self, kernel, params, masters, exp_avgs, exp_avg_sqs):
        self.params, self.masters = list(params), masters
        self.exp_avgs, self.exp_avg_sqs = list(exp_avgs), list(exp_avg_sqs)
        n = len(self.params)
        self.master = masters is not None
        self._ptrs = None
        self._grads = None
        self.codes = np.zeros((n, 3), dtype=np.int32)
        self.sizes = np.zeros((n,), dtype=np.int64)
        for i, p in enumerate(self.params):
            m, v = self.exp_avgs[i], self.exp_avg_sqs[i]
            master = masters[i] if self.master else None
            for t, dt in ((m, torch.float32), (master, torch.float32)):
                if t is not None and t.dtype != dt:
                    raise ValueError(f"{kernel}: moment or master of dtype "
                                     f"{t.dtype}, not fp32")
            if v.dtype not in MOMENT_DTYPES:
                raise ValueError(f"{kernel}: exp_avg_sq dtype {v.dtype} is "
                                 f"not one of {list(MOMENT_DTYPES)}")
            for t in (m, v) + ((master,) if self.master else ()):
                _code(kernel, t)
                if t.numel() != p.numel():
                    raise ValueError(f"{kernel}: state of {t.numel()} "
                                     f"elements for {p.numel()}")
            self.codes[i, 1:] = (_code(kernel, p), _DTYPES[v.dtype])
            self.sizes[i] = p.numel()

    def fill_grads(self, kernel, grads) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{kernel}: {len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        for i, g in enumerate(grads):
            if g.numel() != self.sizes[i]:
                raise ValueError(f"{kernel}: gradient of {g.numel()} "
                                 f"elements for {self.sizes[i]}")
            self.codes[i, 0] = _code(kernel, g)
        self._grads = grads

    @property
    def ptrs(self) -> np.ndarray:
        """``(rows, 5)`` int64: the gradient, parameter, master (0 for
        none), exp_avg and exp_avg_sq pointers of each row."""
        if self._ptrs is None:
            self._ptrs = np.zeros((len(self.params), 5), dtype=np.int64)
            for i, p in enumerate(self.params):
                master = self.masters[i].data_ptr() if self.master else 0
                self._ptrs[i, 1:] = (p.data_ptr(), master,
                                     self.exp_avgs[i].data_ptr(),
                                     self.exp_avg_sqs[i].data_ptr())
        if self._grads is not None:
            self._ptrs[:, 0] = [g.data_ptr() for g in self._grads]
            self._grads = None
        return self._ptrs


def step_rows(params, masters, exp_avgs, exp_avg_sqs,
              kernel: str = KERNEL_ADAM) -> StepRows:
    """The cached part of a step kernel's table (see :class:`StepRows`)."""
    return StepRows(kernel, params, masters, exp_avgs, exp_avg_sqs)


def commit(dst: torch.Tensor, new: torch.Tensor, finite) -> None:
    """``dst = new`` (rounded to dst's dtype), or unchanged where the
    finite flag is false."""
    new = new.to(dst.dtype)
    dst.copy_(new if finite is None else torch.where(finite, new, dst))


def _prep_grad(g, inv_scale, clip):
    gf = _unscaled(g, inv_scale)
    return gf if clip is None else gf * clip


def _moments(g, pw, m, v, b1, b2, c1, omb2, eps, wd, adam_w, bc1, bc2):
    """The moment update and the update direction, each operation rounded
    as the kernel rounds it: ``(update, m, v)`` in fp32."""
    if wd != 0.0 and not adam_w:
        g = g + wd * pw
    m = m * b1 + g * c1
    v = v.float() * b2 + torch.square(g) * omb2
    vh = v if bc2 is None else v / bc2
    mh = m if bc1 is None else m / bc1
    update = mh / (torch.sqrt(vh) + eps)
    if wd != 0.0 and adam_w:
        update = update + wd * pw
    return update, m, v


def _adam_plain(grads, rows, inv_scale, clip, finite, bc1, bc2, hyper):
    b1, b2, c1, omb2, eps, lr, wd, adam_w = hyper
    for i, p in enumerate(rows.params):
        master = rows.masters[i] if rows.master else None
        pw = master if master is not None else p.float()
        g = _prep_grad(grads[i], inv_scale, clip)
        update, m, v = _moments(g, pw, rows.exp_avgs[i], rows.exp_avg_sqs[i],
                                b1, b2, c1, omb2, eps, wd, adam_w, bc1, bc2)
        new = pw - lr * update
        commit(rows.exp_avgs[i], m, finite)
        commit(rows.exp_avg_sqs[i], v, finite)
        if master is not None:
            commit(master, new, finite)
        commit(p, new, finite)


def _hyper(b1, b2, c1, eps, lr, wd, adam_w):
    f = lambda x: float(np.float32(x))
    return (f(b1), f(b2), f(c1), f(np.float32(1.0) - np.float32(b2)),
            f(eps), f(lr), f(wd), bool(adam_w))


def _step_scalars(kernel, dev, clip, inv_scale, bc1, bc2, finite):
    return tuple(_scalar_ptr(kernel, x, dev)
                 for x in (clip, inv_scale, bc1, bc2)) + (
        _flag_ptr(kernel, finite, dev),)


@kernel_entry(_step_costs(KERNEL_ADAM, 14.0))
def adam(grads: Sequence[torch.Tensor], rows: StepRows, *, lr: float,
         beta1: float, beta2: float, eps: float, weight_decay: float,
         adam_w_mode: bool, bc1: Optional[torch.Tensor] = None,
         bc2: Optional[torch.Tensor] = None,
         clip: Optional[torch.Tensor] = None,
         inv_scale: Optional[torch.Tensor] = None,
         finite: Optional[torch.Tensor] = None) -> None:
    """One Adam step over ``rows`` (:func:`step_rows`) with these
    gradients, in place: the moments, the fp32 masters where there are
    any, and the parameters.  ``bc1``/``bc2`` (the bias corrections),
    ``clip`` (multiplies each gradient), ``inv_scale`` (unscales each
    gradient through its dtype first) are fp32 0-d device tensors or
    None; ``finite`` (a 0-d bool) false leaves everything unchanged.
    The coefficients are rounded to fp32 as JAX computes them:
    ``1 - beta1`` and ``1 - beta2`` in fp32."""
    grads = list(grads)
    rows.fill_grads(KERNEL_ADAM, grads)
    hyper = _hyper(beta1, beta2, np.float32(1.0) - np.float32(beta1), eps,
                   lr, weight_decay, adam_w_mode)
    dev = _device(KERNEL_ADAM, grads, rows.params)
    if dev is None:
        return
    if dev.type != "cuda":
        _adam_plain(grads, rows, inv_scale, clip, finite, bc1, bc2, hyper)
    else:
        _adam_cuda(dev, grads, rows, hyper, clip, inv_scale, bc1, bc2,
                   finite)


def _adam_cuda(dev, grads, rows, hyper, clip, inv_scale, bc1, bc2,
               finite) -> None:
    if not rows.sizes.any():
        return
    scalars = _step_scalars(KERNEL_ADAM, dev, clip, inv_scale, bc1, bc2,
                            finite)
    lib, fn = _entry(KERNEL_ADAM)
    with count_launch(KERNEL_ADAM):
        err = fn(rows.ptrs.ctypes.data, rows.sizes.ctypes.data,
                 rows.codes.ctypes.data, len(grads), int(rows.master),
                 *scalars, *hyper[:7], int(hyper[7]), stream_of(grads[0]))
    check(lib, KERNEL_ADAM, err)


def _lamb_plain(grads, rows, inv_scale, clip, finite, bc1, bc2, hyper,
                use_trust):
    b1, b2, c1, omb2, eps, lr, wd, adam_w = hyper
    for i, p in enumerate(rows.params):
        master = rows.masters[i] if rows.master else None
        pw = master if master is not None else p.float()
        g = _prep_grad(grads[i], inv_scale, clip)
        update, m, v = _moments(g, pw, rows.exp_avgs[i], rows.exp_avg_sqs[i],
                                b1, b2, c1, omb2, eps, wd, adam_w, bc1, bc2)
        if use_trust:
            w_norm = torch.sqrt(torch.sum(torch.square(pw)))
            u_norm = torch.sqrt(torch.sum(torch.square(update)))
            trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                                torch.ones_like(w_norm))
            new = pw - (lr * trust) * update
        else:
            new = pw - lr * update
        commit(rows.exp_avgs[i], m, finite)
        commit(rows.exp_avg_sqs[i], v, finite)
        if master is not None:
            commit(master, new, finite)
        commit(p, new, finite)


@kernel_entry(_step_costs(KERNEL_LAMB, 20.0))
def lamb(grads: Sequence[torch.Tensor], rows: StepRows, *, lr: float,
         beta1: float, beta2: float, beta3: float, eps: float,
         weight_decay: float, adam_w_mode: bool, use_trust: bool,
         bc1: Optional[torch.Tensor] = None,
         bc2: Optional[torch.Tensor] = None,
         clip: Optional[torch.Tensor] = None,
         inv_scale: Optional[torch.Tensor] = None,
         finite: Optional[torch.Tensor] = None) -> None:
    """One LAMB step over ``rows`` (as :func:`adam`, with ``beta3`` the
    first moment's gradient weight): the update ``u`` of each tensor, its
    trust ratio ``|p| / |u|`` (1 where either norm is 0, and everywhere
    without ``use_trust``), then ``p -= (lr * trust) * u``."""
    grads = list(grads)
    rows.fill_grads(KERNEL_LAMB, grads)
    hyper = _hyper(beta1, beta2, beta3, eps, lr, weight_decay, adam_w_mode)
    dev = _device(KERNEL_LAMB, grads, rows.params)
    if dev is None:
        return
    if dev.type != "cuda":
        _lamb_plain(grads, rows, inv_scale, clip, finite, bc1, bc2, hyper,
                    use_trust)
    else:
        _lamb_cuda(dev, grads, rows, hyper, use_trust, clip, inv_scale, bc1,
                   bc2, finite)


def _lamb_cuda(dev, grads, rows, hyper, use_trust, clip, inv_scale, bc1,
               bc2, finite) -> None:
    sizes = rows.sizes
    chunks = int(sum(-(-int(s) // CHUNK) for s in sizes))
    if chunks == 0:
        return
    padded = -(-sizes // VEC) * VEC
    u_off = _arr(np.concatenate([[0], np.cumsum(padded)[:-1]]))
    u = torch.empty((int(padded.sum()),), dtype=torch.float32, device=dev)
    partials = torch.empty((2 * chunks,), dtype=torch.float32, device=dev)
    trust = torch.ones((len(grads),), dtype=torch.float32, device=dev)
    scalars = _step_scalars(KERNEL_LAMB, dev, clip, inv_scale, bc1, bc2,
                            finite)
    lib, fn = _entry(KERNEL_LAMB)
    with count_launch(KERNEL_LAMB):
        err = fn(rows.ptrs.ctypes.data, sizes.ctypes.data,
                 rows.codes.ctypes.data, len(grads), int(rows.master),
                 *scalars, u.data_ptr(), u_off.ctypes.data,
                 partials.data_ptr(), trust.data_ptr(), *hyper[:7],
                 int(hyper[7]), int(use_trust), stream_of(grads[0]))
    check(lib, KERNEL_LAMB, err)
