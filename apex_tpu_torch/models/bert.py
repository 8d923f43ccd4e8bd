"""Megatron-style BERT: a bidirectional encoder with a masked-LM head and a
binary (NSP/SOP) head, trained and fine-tuned on one GPU through the
port's kernels.

Counterpart of ``apex_tpu/models/bert.py``.  As with the port's GPT, the
JAX factory of pure functions over a stacked parameter tree becomes an
``nn.Module`` whose layers are a ``ModuleList``; the module names follow
the JAX tree (``embedding``, ``pos_embedding``, ``tokentype_embedding``,
``layers.<i>.{ln1, qkv, attn_proj, ln2, fc1, fc2}``, ``final_ln``,
``lm_head.{dense, ln, bias}``, ``pooler``, ``binary_head``), so
``apex_tpu_torch.convert`` carries weights across both ways.  The math is
kept exactly:

- pre-norm layers: ``x + attn_proj(attention(ln1(x)))``, then ``x +
  fc2(gelu(fc1(ln2(x))))`` with ``gelu(approximate="tanh")``, the
  residual stream in the compute dtype, the final norm over an fp32 copy;
- the qkv output grouped per head, ``[h0_q h0_k h0_v h1_q ...]``;
- padding reaches the attention as segment ids: every query is segment 0,
  a kept key 0 and a padded key -2 (:meth:`BertModel._kv_segments`), so a
  padded key is never seen, as under the reference's additive -inf mask;
- the MLM head is dense + GELU + an fp32 layer norm, then the tied
  embedding with a per-vocab bias; the binary head pools token 0 through
  ``tanh``;
- the loss is the masked-LM mean over ``loss_mask`` positions plus the
  binary cross entropy.

Attention goes through ``ops.attention.flash_attention`` with segment ids
(at s <= 512 the short kernel's segment instance, ``short_fwd_seg`` /
``short_bwd_seg``; ``attention_impl`` forces the mid or flash rung), every
norm through the layer-norm kernel; on the CPU the same calls run the
kernels' plain versions.  ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the port's GPT does.

The MLM loss takes the two-step or the fused chunked LM-head cross
entropy by ``fused_ce`` (None: by logits size, as in JAX); on the fused
path the head's per-vocab bias is the fused path's ``bias``.  Not ported
yet, raising ``NotImplementedError`` naming their ROADMAP.md items: the
pipeline paths (``pipeline_loss``, ``pipeline_grads``; queue A item 10,
A9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.amp.policy import Policy, check_ported
from apex_tpu_torch.models.gpt import Norm
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    lm_head_cross_entropy,
    normal_init,
)
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["BertConfig", "BertModel"]

#: the padded-key segment id of :meth:`BertModel._kv_segments` (queries
#: are all segment 0, so such a key is never seen)
PAD_KEY_SEGMENT = -2


@dataclasses.dataclass
class BertConfig:
    """Hyperparameters, as in the JAX package's ``BertConfig``.

    ``policy`` (an ``apex_tpu_torch.amp.Policy``) overrides
    ``params_dtype``/``compute_dtype`` and keeps norm parameters fp32 when
    it says so.  ``remat`` recomputes each layer in the backward: the port
    saves only each layer's input, less than the JAX ``remat_policy``
    keeps, with the same numbers, so ``remat_policy`` is accepted and
    changes nothing.  ``attention_impl`` forces a rung (``"short"``,
    ``"mid"``, ``"pallas"`` the flash rung) or leaves the ladder to choose
    (None).  ``fused_ce`` None picks the LM-head cross entropy by logits
    size, as in JAX; True and False force the fused chunked and the
    two-step paths."""

    vocab_size: int = 32000
    num_layers: int = 4
    hidden_size: int = 512
    num_attention_heads: int = 8
    max_position_embeddings: int = 512
    num_tokentypes: int = 2
    ffn_hidden_size: Optional[int] = None
    layernorm_epsilon: float = 1e-5
    init_method_std: float = 0.02
    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    policy: Optional[Policy] = None
    remat: bool = True
    remat_policy: Optional[str] = "dots_with_no_batch_dims_saveable"
    fused_ce: Optional[bool] = None
    fused_ce_chunk: int = 8192
    add_binary_head: bool = True
    attention_impl: Optional[str] = None

    def __post_init__(self):
        if self.policy is not None:
            check_ported(self.policy)
            self.params_dtype = self.policy.param_dtype
            self.compute_dtype = self.policy.compute_dtype
        if self.attention_impl not in (None, "short", "mid", "pallas"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r}: the port has the "
                "short, mid and flash ('pallas') rungs; its plain "
                "attention (the JAX 'xla' path) is an oracle, not a rung")
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                "hidden_size must be divisible by num_attention_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def norm_dtype(self) -> torch.dtype:
        """Norm parameter dtype: fp32 under a keep-norm-fp32 policy."""
        if self.policy is not None and self.policy.keep_norm_fp32:
            return torch.float32
        return self.params_dtype


class BertLayer(nn.Module):
    """One encoder layer's parameters (the JAX ``layers`` subtree at one
    index of the stacked dim)."""

    def __init__(self, c: BertConfig, device, generator):
        super().__init__()
        init = normal_init(c.init_method_std)
        # Megatron output-layer init: std / sqrt(2 * L)
        out_init = normal_init(c.init_method_std / math.sqrt(2.0 * c.num_layers))
        kw = dict(params_dtype=c.params_dtype, device=device,
                  generator=generator)
        norm = lambda: Norm(c.hidden_size, "layernorm", c.layernorm_epsilon,
                            c.norm_dtype, device)
        self.ln1 = norm()
        self.qkv = ColumnParallelLinear(c.hidden_size, 3 * c.hidden_size,
                                        init_method=init, **kw)
        self.attn_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                           init_method=out_init, **kw)
        self.ln2 = norm()
        self.fc1 = ColumnParallelLinear(c.hidden_size, c.ffn_hidden_size,
                                        init_method=init, **kw)
        self.fc2 = RowParallelLinear(c.ffn_hidden_size, c.hidden_size,
                                     init_method=out_init, **kw)


class MLMHead(nn.Module):
    """The masked-LM head's parameters: ``dense`` (h -> h), ``ln`` and the
    per-vocab output ``bias`` of the tied-embedding logits."""

    def __init__(self, c: BertConfig, device, generator):
        super().__init__()
        self.dense = ColumnParallelLinear(
            c.hidden_size, c.hidden_size,
            init_method=normal_init(c.init_method_std),
            params_dtype=c.params_dtype, device=device, generator=generator)
        self.ln = Norm(c.hidden_size, "layernorm", c.layernorm_epsilon,
                       c.norm_dtype, device)
        self.bias = nn.Parameter(torch.zeros(
            c.vocab_size, dtype=c.params_dtype, device=device))


class BertModel(nn.Module):
    """Bidirectional encoder LM with an MLM and a binary head.

    ``device`` defaults to the GPU (and raises without one); pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels.
    Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    (load JAX weights with :func:`apex_tpu_torch.convert.params_from_jax`
    and ``load_state_dict``)."""

    def __init__(self, config: BertConfig, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init = normal_init(c.init_method_std)
        kw = dict(params_dtype=c.params_dtype, device=self.device,
                  generator=gen)
        self.embedding = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, init_method=init, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(
            (c.max_position_embeddings, c.hidden_size),
            dtype=c.params_dtype, device=self.device))
        init(self.pos_embedding, gen)
        self.tokentype_embedding = nn.Parameter(torch.empty(
            (c.num_tokentypes, c.hidden_size), dtype=c.params_dtype,
            device=self.device))
        init(self.tokentype_embedding, gen)
        self.layers = nn.ModuleList(
            BertLayer(c, self.device, gen) for _ in range(c.num_layers))
        self.final_ln = Norm(c.hidden_size, "layernorm", c.layernorm_epsilon,
                             c.norm_dtype, self.device)
        self.lm_head = MLMHead(c, self.device, gen)
        if c.add_binary_head:
            self.pooler = ColumnParallelLinear(
                c.hidden_size, c.hidden_size, init_method=init, **kw)
            self.binary_head = ColumnParallelLinear(
                c.hidden_size, 2, init_method=init, **kw)
        else:
            self.pooler = self.binary_head = None

    # ------------------------------------------------------------ forward
    def _layer(self, layer: BertLayer, x: torch.Tensor, q_seg=None,
               kv_seg=None) -> torch.Tensor:
        """One encoder layer over ``x (b, s, h)``; ``q_seg``/``kv_seg``
        ``(b, s)`` are the padding's segment ids (None: no padding)."""
        c = self.config
        b, s, _ = x.shape
        residual = x
        y = layer.ln1(x).to(c.compute_dtype)
        qkv = layer.qkv(y).reshape(b, s, c.num_attention_heads, 3,
                                   c.head_dim)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
        attn = flash_attention(q, k, v, causal=False, q_segment_ids=q_seg,
                               kv_segment_ids=kv_seg,
                               implementation=c.attention_impl)
        attn = attn.transpose(1, 2).reshape(b, s, c.hidden_size)
        x = residual + layer.attn_proj(attn).to(residual.dtype)
        residual = x
        y = layer.ln2(x).to(c.compute_dtype)
        y = layer.fc2(F.gelu(layer.fc1(y), approximate="tanh"))
        return residual + y.to(residual.dtype)

    def _embed(self, tokens: torch.Tensor,
               tokentype_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Word + position (+ tokentype) embedding, in the compute dtype."""
        c = self.config
        s = tokens.shape[1]
        if s > c.max_position_embeddings:
            raise ValueError(f"sequence of {s} tokens past the position "
                             f"table's {c.max_position_embeddings}")
        x = self.embedding(tokens)
        x = x + self.pos_embedding[:s][None].to(x.dtype)
        if tokentype_ids is not None:
            x = x + self.tokentype_embedding[tokentype_ids.long()].to(x.dtype)
        return x.to(c.compute_dtype)

    def _final_ln(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm over an fp32 copy, out in the compute dtype."""
        return self.final_ln(x.float()).to(self.config.compute_dtype)

    @staticmethod
    def _kv_segments(attention_mask: torch.Tensor) -> torch.Tensor:
        """Kept keys are segment 0 and masked ones
        :data:`PAD_KEY_SEGMENT`, which no query has, so they are excluded
        exactly like the reference's additive -inf mask."""
        return torch.where(attention_mask.bool(), 0,
                           PAD_KEY_SEGMENT).to(torch.int32)

    def encode(self, tokens: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               tokentype_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``tokens (b, s)``; ``attention_mask (b, s)`` True where a token
        is kept.  Returns ``(b, s, h)`` final-normed hidden states in the
        compute dtype."""
        x = self._embed(tokens, tokentype_ids)
        segs = (None, None)
        if attention_mask is not None:
            kv_seg = self._kv_segments(attention_mask)
            segs = (torch.zeros_like(kv_seg), kv_seg)
        remat = self.config.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(self._layer, layer, x, *segs,
                               use_reentrant=False)
            else:
                x = self._layer(layer, x, *segs)
        return self._final_ln(x)

    def mlm_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """The MLM head's transform (dense + GELU + an fp32 norm) before
        the tied vocab projection, in ``hidden``'s dtype."""
        hd = self.lm_head
        h = torch.matmul(hidden, hd.dense.weight.to(hidden.dtype))
        h = F.gelu(h + hd.dense.bias.to(h.dtype), approximate="tanh")
        return hd.ln(h.float()).to(hidden.dtype)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """MLM head -> logits ``(b, s, vocab)``."""
        h = self.mlm_hidden(hidden)
        logits = torch.matmul(h, self.embedding.weight.to(h.dtype).t())
        return logits + self.lm_head.bias.to(logits.dtype)

    def _per_token_ce(self, hidden: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """Per-token MLM cross entropy through the tied head and its
        per-vocab bias (fused or two-step, by ``config.fused_ce``)."""
        c = self.config
        return lm_head_cross_entropy(
            self.mlm_hidden(hidden), self.embedding.weight, labels,
            fused=c.fused_ce, chunk=c.fused_ce_chunk,
            bias=self.lm_head.bias)

    def binary_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Pooled token 0 -> the 2-way head's fp32 logits ``(b, 2)``."""
        if self.pooler is None:
            raise ValueError("the model was built with add_binary_head="
                             "False")
        pooled = torch.tanh(self.pooler(hidden[:, 0]))
        return self.binary_head(pooled).float()

    def apply(self, tokens: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None,
              tokentype_ids: Optional[torch.Tensor] = None):
        """``(lm_logits (b, s, vocab), binary_logits (b, 2) or None)``."""
        hidden = self.encode(tokens, attention_mask, tokentype_ids)
        lm = self.lm_logits(hidden)
        if self.config.add_binary_head:
            return lm, self.binary_logits(hidden)
        return lm, None

    forward = apply

    # ----------------------------------------------------------- training
    def loss(self, tokens: torch.Tensor, lm_labels: torch.Tensor,
             loss_mask: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None,
             binary_labels: Optional[torch.Tensor] = None,
             tokentype_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The masked-LM cross entropy averaged over ``loss_mask``
        positions, plus the binary head's mean cross entropy when
        ``binary_labels`` are given (fp32 scalar)."""
        hidden = self.encode(tokens, attention_mask, tokentype_ids)
        binary = (self.binary_logits(hidden)
                  if self.config.add_binary_head else None)
        per_token = self._per_token_ce(hidden, lm_labels)
        mask = loss_mask.float()
        loss = (per_token * mask).sum() / mask.sum().clamp_min(1.0)
        if binary is not None and binary_labels is not None:
            logp = F.log_softmax(binary, dim=-1)
            loss = loss - logp.gather(
                1, binary_labels.long()[:, None])[:, 0].mean()
        return loss

    # ------------------------------------------------------ pipeline path
    def pipeline_loss(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "BertModel.pipeline_loss: pipeline schedules are not ported yet "
            "(ROADMAP.md queue A item 10, A9)")

    def pipeline_grads(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            "BertModel.pipeline_grads: pipeline schedules are not ported yet "
            "(ROADMAP.md queue A item 10, A9)")
