"""Fused multi-head attention modules: self- and encoder-decoder attention.

Counterpart of ``apex_tpu/contrib/multihead_attn/__init__.py`` (the
reference's ``apex.contrib.multihead_attn``), for fairseq-style
Transformer encoder-decoders.  Inputs are ``(seq, batch, hidden)`` (SBH),
the torch MHA layout.  The packed projections keep the JAX layouts: a
``qkv_weight (embed, 3 * embed)`` whose output dim is grouped per head as
``(q, k, v)`` triplets, ``kv_weight (embed, 2 * embed)`` grouped as ``(k,
v)`` pairs, linear weights ``(in, out)``.  The parameter names are the JAX
tree's (``qkv_weight``, ``out_weight``, ``qkv_bias``, ``lyr_nrm.scale``,
...), so ``load_state_dict(convert.params_from_jax(params))`` loads a JAX
tree strictly.

``impl="fast"`` runs :func:`~apex_tpu_torch.ops.attention.flash_attention`
(the attention kernels; ``attention_impl`` forces a rung) and
``impl="default"`` the plain :func:`~apex_tpu_torch.ops.attention.
mha_reference`, the reference's own fast-vs-default pair.  The masks are
converted as in JAX: a boolean ``attn_mask`` (True = masked) becomes an
additive bias of -1e30 (a 2-D one broadcast to ``(b, 1, s, s)`` as a view,
never copied per batch row or head), a float one is the bias itself; a
``key_padding_mask`` ``(b, sk)`` (True = padded key) becomes segment ids,
keys -2 and queries 0.  The fast path passes ``bias_requires_grad=False``
(the mask is a constant, never a parameter), so it runs the kernels'
bias instances and no bias gradient.  Attention dropout draws its seed as
``bits(rng)`` through :mod:`apex_tpu_torch.random`, so for one key the
masks are JAX's, bit for bit; without ``rng`` or with ``is_training=False``
nothing is dropped.

Parameters are drawn as the JAX ``init`` draws them (Xavier-uniform from
``key``, split as JAX splits it), bit for bit for fp32 parameters;
``device`` defaults to the GPU, ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from apex_tpu_torch import random as prng
from apex_tpu_torch.amp.policy import Policy, check_ported
from apex_tpu_torch.ops.attention import flash_attention, mha_reference
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]

#: the additive bias a boolean ``attn_mask`` puts on a masked score
MASKED_SCORE = -1e30
#: the key padding's segment id (queries are 0)
PAD_KEY_SEGMENT = -2


def _xavier(key, shape, dtype, device, gain: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, -a, a)`` with the Xavier
    bound ``a`` of ``shape``: the fp32 draw of
    :func:`apex_tpu_torch.random.uniform_tensor` on ``device``, scaled and
    shifted with one fp32 rounding (``u * span + lo`` fused, as XLA
    computes it on the CPU: the float64 product of two fp32 values is
    exact), then cast to ``dtype``."""
    fan_in, fan_out = shape[0], shape[-1]
    a = np.float32(gain * math.sqrt(6.0 / (fan_in + fan_out)))
    lo, span = float(-a), float(np.float32(a - (-a)))
    u = prng.uniform_tensor(key, shape, device).double()
    x = (u * span + lo).float().clamp_min(lo)
    return x.to(dtype)


def _attend(q, k, v, scale, mask_bias, causal, impl, kv_pad_mask=None,
            dropout_rate=0.0, rng=None, attention_impl=None):
    """Attention over ``(b, h, s, d)``.  ``mask_bias``: an additive bias
    broadcastable to ``(b, 1, sq, sk)`` or None; ``kv_pad_mask (b, sk)``
    True where a key is padding.  Dropout (seeded by ``bits(rng)``)
    happens inside the attention, on the kernels' mask or the plain
    path's, which are the same."""
    q_seg = kv_seg = None
    if kv_pad_mask is not None:
        # segment ids keep the padding out inside the kernels
        kv_seg = torch.where(kv_pad_mask.to(q.device), PAD_KEY_SEGMENT,
                             0).to(torch.int32)
        q_seg = torch.zeros((q.shape[0], q.shape[2]), dtype=torch.int32,
                            device=q.device)
    seed = None
    if dropout_rate > 0.0 and rng is not None:
        seed = prng.seed_of(rng)
    else:
        dropout_rate = 0.0
    kwargs = dict(causal=causal, sm_scale=scale, bias=mask_bias,
                  q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                  dropout_rate=dropout_rate, dropout_seed=seed)
    if impl == "fast":
        # attn_mask is a constant mask, never a parameter: no dBias
        return flash_attention(q, k, v, bias_requires_grad=False,
                               implementation=attention_impl, **kwargs)
    return mha_reference(q, k, v, **kwargs)


class _LayerNormParams(nn.Module):
    """The fused norm's ``scale`` and ``bias`` (the JAX ``lyr_nrm``)."""

    def __init__(self, n: int, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(n, dtype=dtype, device=device))


class _MHABase(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        bias: bool = False,
        include_norm_add: bool = False,
        impl: str = "fast",
        params_dtype: torch.dtype = torch.float32,
        policy: Optional[Policy] = None,
        attention_impl: Optional[str] = None,
        *,
        device=None,
    ):
        super().__init__()
        norm_dtype = params_dtype
        if policy is not None:  # an amp Policy drives the param dtypes
            check_ported(policy)
            params_dtype = policy.param_dtype
            norm_dtype = (torch.float32 if policy.keep_norm_fp32
                          else policy.param_dtype)
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"unsupported impl: {impl!r}")
        if attention_impl not in (None, "short", "mid", "pallas"):
            raise NotImplementedError(
                f"attention_impl={attention_impl!r}: the port has the short, "
                "mid and flash ('pallas') rungs; its plain attention (the JAX "
                "'xla' path) is impl='default', not a rung")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.dropout = dropout
        self.use_bias = bias
        self.include_norm_add = include_norm_add
        self.impl = impl
        # the rung for impl='fast': None = the ladder, or "short"/"mid"/
        # "pallas"
        self.attention_impl = attention_impl
        self.params_dtype = params_dtype
        self.norm_dtype = norm_dtype
        self.device = resolve_device(device)

    def _zeros(self, n: int) -> nn.Parameter:
        return nn.Parameter(torch.zeros(n, dtype=self.params_dtype,
                                        device=self.device))

    def _xavier(self, key, shape) -> nn.Parameter:
        return nn.Parameter(_xavier(key, shape, self.params_dtype,
                                    self.device))

    def _init_norm(self) -> None:
        if self.include_norm_add:
            self.lyr_nrm = _LayerNormParams(self.embed_dim, self.norm_dtype,
                                            self.device)

    def _maybe_norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.include_norm_add:
            return fused_layer_norm_affine(
                x, self.lyr_nrm.scale, self.lyr_nrm.bias, (self.embed_dim,))
        return x

    def _sbh_to_bhsd(self, x: torch.Tensor) -> torch.Tensor:
        s, b, _ = x.shape
        return x.reshape(s, b, self.num_heads, self.head_dim).permute(
            1, 2, 0, 3)

    def _bhsd_to_sbh(self, x: torch.Tensor) -> torch.Tensor:
        b, h, s, d = x.shape
        return x.permute(2, 0, 1, 3).reshape(s, b, h * d)

    def _project_out(self, ctx: torch.Tensor, query: torch.Tensor):
        out = torch.matmul(self._bhsd_to_sbh(ctx),
                           self.out_weight.to(ctx.dtype))
        if self.use_bias:
            out = out + self.out_bias.to(out.dtype)
        if self.include_norm_add:
            out = out + query  # the fused residual add (norm-add variant)
        return out


class SelfMultiheadAttn(_MHABase):
    """Self-attention (reference: self_multihead_attn.py:26-124).

    ``forward(query, key_padding_mask=None, attn_mask=None, causal=False,
    is_training=True, rng=None)`` -> ``(seq, batch, hidden)``, the JAX
    ``apply`` without ``params``; with ``include_norm_add`` the residual
    add of the *input* is fused in, as the reference's norm-add variants
    do.  ``key`` (an :mod:`apex_tpu_torch.random` key, default
    ``PRNGKey(0)``) draws the parameters as JAX ``init(key)`` does."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", params_dtype: torch.dtype = torch.float32,
                 policy: Optional[Policy] = None,
                 attention_impl: Optional[str] = None, *, device=None,
                 key=None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, params_dtype, policy,
                         attention_impl, device=device)
        k1, k2 = prng.split(prng.PRNGKey(0) if key is None else key)
        e = embed_dim
        # packed qkv, output dim grouped per head as (q, k, v) triplets
        self.qkv_weight = self._xavier(k1, (e, 3 * e))
        self.out_weight = self._xavier(k2, (e, e))
        if bias:
            self.qkv_bias = self._zeros(3 * e)
            self.out_bias = self._zeros(e)
        self._init_norm()

    def forward(
        self,
        query: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        causal: bool = False,
        is_training: bool = True,
        rng=None,
    ) -> torch.Tensor:
        s, b, _ = query.shape
        x = self._maybe_norm(query)
        qkv = torch.matmul(x, self.qkv_weight.to(x.dtype))
        if self.use_bias:
            qkv = qkv + self.qkv_bias.to(qkv.dtype)
        qkv = qkv.reshape(s, b, self.num_heads, 3, self.head_dim)
        q, k, v = (qkv[:, :, :, i].permute(1, 2, 0, 3) for i in range(3))

        bias = None
        if attn_mask is not None:
            attn_mask = attn_mask.to(query.device)
            bias = (torch.where(attn_mask, MASKED_SCORE, 0.0)
                    if attn_mask.dtype == torch.bool else attn_mask)
            if bias.ndim == 2:
                bias = bias.expand(b, 1, s, s)

        ctx = _attend(q, k, v, self.scale, bias, causal, self.impl,
                      kv_pad_mask=key_padding_mask,
                      dropout_rate=self.dropout if is_training else 0.0,
                      rng=rng, attention_impl=self.attention_impl)
        return self._project_out(ctx, query)


class EncdecMultiheadAttn(_MHABase):
    """Encoder-decoder attention (reference: encdec_multihead_attn.py):
    Q from the decoder stream, K/V projected together from the encoder
    stream.  ``forward(query, key, key_padding_mask=None,
    is_training=True, rng=None)``; ``key`` as for
    :class:`SelfMultiheadAttn` (JAX ``init`` splits it in three)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", params_dtype: torch.dtype = torch.float32,
                 policy: Optional[Policy] = None,
                 attention_impl: Optional[str] = None, *, device=None,
                 key=None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, params_dtype, policy,
                         attention_impl, device=device)
        k1, k2, k3 = prng.split(prng.PRNGKey(0) if key is None else key, 3)
        e = embed_dim
        self.q_weight = self._xavier(k1, (e, e))
        self.kv_weight = self._xavier(k2, (e, 2 * e))
        self.out_weight = self._xavier(k3, (e, e))
        if bias:
            self.q_bias = self._zeros(e)
            self.kv_bias = self._zeros(2 * e)
            self.out_bias = self._zeros(e)
        self._init_norm()

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        is_training: bool = True,
        rng=None,
    ) -> torch.Tensor:
        x = self._maybe_norm(query)
        q = torch.matmul(x, self.q_weight.to(x.dtype))
        if self.use_bias:
            q = q + self.q_bias.to(q.dtype)
        kv = torch.matmul(key, self.kv_weight.to(key.dtype))
        if self.use_bias:
            kv = kv + self.kv_bias.to(kv.dtype)
        sk, b, _ = key.shape
        kv = kv.reshape(sk, b, self.num_heads, 2, self.head_dim)
        k_, v_ = (kv[:, :, :, i].permute(1, 2, 0, 3) for i in range(2))
        q = self._sbh_to_bhsd(q)

        ctx = _attend(q, k_, v_, self.scale, None, False, self.impl,
                      kv_pad_mask=key_padding_mask,
                      dropout_rate=self.dropout if is_training else 0.0,
                      rng=rng, attention_impl=self.attention_impl)
        return self._project_out(ctx, query)
