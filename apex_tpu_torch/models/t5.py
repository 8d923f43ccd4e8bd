"""T5-style encoder-decoder transformer, trained on one GPU through the
port's kernels.

Counterpart of ``apex_tpu/models/t5.py``.  As with the port's GPT and
BERT, the JAX factory of pure functions over a parameter tree with two
stacked layer dims becomes an ``nn.Module`` with two ``ModuleList``s,
``enc_layers`` and ``dec_layers``, of one layer struct (``ln1``, ``qkv``,
``attn_proj``, ``ln_cross``, ``cross_q``, ``cross_kv``, ``cross_proj``,
``ln2``, ``fc1``, ``fc2``), beside ``embedding``, ``enc_pos_embedding``,
``dec_pos_embedding``, ``enc_final_ln`` and ``dec_final_ln``; so
``apex_tpu_torch.convert`` carries weights across both ways.  The math is
kept exactly:

- learned absolute position tables, added in the embedding's dtype and
  then cast to the compute dtype (no relative-position bias: the JAX
  sequential path passes none);
- pre-norm layers: the encoder's ``x + attn_proj(attention(ln1(x)))``
  (bidirectional) then ``x + fc2(gelu(fc1(ln2(x))))``; the decoder's
  causal self-attention, then cross attention ``x + cross_proj(
  attention(cross_q(ln_cross(x)), cross_kv(memory)))`` with the memory
  cast to the compute dtype, then the MLP; ``gelu(approximate="tanh")``;
- the qkv and cross kv outputs grouped per head, as in the GPT;
- the final norms over an fp32 copy of the stream, out in the compute
  dtype; a tied LM head and the loss through the shared LM-head cross
  entropy dispatch (``fused_ce``: the fused chunked path or the two-step
  one, None by logits size).

Encoder layers own cross-attention weights that they never apply, and JAX
gives them zero gradients; here an unused parameter would get none, so
:meth:`T5Model.encode` gives them explicit zero gradients and an optimizer
steps them as JAX's does, weight decay included.

Attention goes through ``ops.attention.flash_attention`` (the short
kernel while both lengths are at most 512, the mid kernel up to 2048;
cross attention keys on the longer of the two streams), every norm
through the layer-norm kernel; on the CPU the same calls run their plain
versions.  ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the port's GPT does.  The pipeline entry
points raise ``NotImplementedError`` naming ROADMAP.md queue A item 9.
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

__all__ = ["T5Config", "T5Model"]

#: the cross-attention parameters an encoder layer owns and never applies
CROSS_LEAVES = ("ln_cross", "cross_q", "cross_kv", "cross_proj")


@dataclasses.dataclass
class T5Config:
    """Hyperparameters, as in the JAX package's ``T5Config``.

    ``policy`` (an ``apex_tpu_torch.amp.Policy``) overrides
    ``params_dtype``/``compute_dtype`` and keeps norm parameters fp32 when
    it says so.  ``remat`` recomputes each layer in the backward: the
    port saves only each layer's input, so ``remat_policy`` is accepted
    and changes nothing, as in the GPT.  ``fused_ce`` None picks the
    LM-head cross entropy by logits size, as in JAX.  ``attention_impl``
    forces a rung (``"short"``, ``"mid"``, ``"pallas"``) or leaves the
    ladder to choose (None).  ``fused_pipeline`` belongs to the pipeline
    path (queue A item 9) and is accepted for the JAX signature."""

    vocab_size: int = 32000
    num_encoder_layers: int = 2
    num_decoder_layers: int = 2
    hidden_size: int = 256
    num_attention_heads: int = 4
    max_position_embeddings: int = 512
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
    attention_impl: Optional[str] = None
    fused_pipeline: bool = True

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


class T5Layer(nn.Module):
    """One layer's parameters, the same struct on both sides (the JAX
    ``enc_layers`` / ``dec_layers`` subtree at one index)."""

    def __init__(self, c: T5Config, device, generator):
        super().__init__()
        depth = c.num_encoder_layers + c.num_decoder_layers
        init = normal_init(c.init_method_std)
        out_init = normal_init(c.init_method_std / math.sqrt(2.0 * depth))
        kw = dict(params_dtype=c.params_dtype, device=device,
                  generator=generator)
        h = c.hidden_size

        def norm():
            return Norm(h, "layernorm", c.layernorm_epsilon, c.norm_dtype,
                        device)

        self.ln1 = norm()
        self.qkv = ColumnParallelLinear(h, 3 * h, init_method=init, **kw)
        self.attn_proj = RowParallelLinear(h, h, init_method=out_init, **kw)
        self.ln_cross = norm()
        self.cross_q = ColumnParallelLinear(h, h, init_method=init, **kw)
        self.cross_kv = ColumnParallelLinear(h, 2 * h, init_method=init, **kw)
        self.cross_proj = RowParallelLinear(h, h, init_method=out_init, **kw)
        self.ln2 = norm()
        self.fc1 = ColumnParallelLinear(h, c.ffn_hidden_size,
                                        init_method=init, **kw)
        self.fc2 = RowParallelLinear(c.ffn_hidden_size, h,
                                     init_method=out_init, **kw)

    def cross_parameters(self) -> list:
        return [p for name in CROSS_LEAVES
                for p in getattr(self, name).parameters()]


class _ZeroGrads(torch.autograd.Function):
    """Identity on ``x`` that gives each of ``params`` a zero gradient:
    JAX's gradient of a parameter the forward never reads."""

    @staticmethod
    def forward(ctx, x, *params):
        ctx.shapes = [(p.shape, p.dtype, p.device) for p in params]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=dev)
                            for s, d, dev in ctx.shapes)


class T5Model(nn.Module):
    """Encoder-decoder transformer LM (see the module docstring).

    ``device`` defaults to the GPU (and raises without one); pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels.
    Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    (load JAX weights with :func:`apex_tpu_torch.convert.params_from_jax`
    and ``load_state_dict``)."""

    def __init__(self, config: T5Config, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init = normal_init(c.init_method_std)
        self.embedding = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, init_method=init,
            params_dtype=c.params_dtype, device=self.device, generator=gen)

        def table():
            t = nn.Parameter(torch.empty(
                (c.max_position_embeddings, c.hidden_size),
                dtype=c.params_dtype, device=self.device))
            init(t, gen)
            return t

        self.enc_pos_embedding = table()
        self.dec_pos_embedding = table()
        self.enc_layers = nn.ModuleList(
            T5Layer(c, self.device, gen)
            for _ in range(c.num_encoder_layers))
        self.dec_layers = nn.ModuleList(
            T5Layer(c, self.device, gen)
            for _ in range(c.num_decoder_layers))

        def norm():
            return Norm(c.hidden_size, "layernorm", c.layernorm_epsilon,
                        c.norm_dtype, self.device)

        self.enc_final_ln = norm()
        self.dec_final_ln = norm()

    # ------------------------------------------------------------ forward
    def _heads(self, y: torch.Tensor, n: int) -> tuple:
        """``(b, s, heads * n * d)`` grouped per head -> ``n`` tensors of
        ``(b, heads, s, d)``."""
        c = self.config
        b, s, _ = y.shape
        y = y.reshape(b, s, c.num_attention_heads, n, c.head_dim)
        return tuple(y[:, :, :, i].transpose(1, 2) for i in range(n))

    @staticmethod
    def _merge(attn: torch.Tensor) -> torch.Tensor:
        b, h, s, d = attn.shape
        return attn.transpose(1, 2).reshape(b, s, h * d)

    def _self_attention(self, layer: T5Layer, x: torch.Tensor,
                        causal: bool) -> torch.Tensor:
        c = self.config
        q, k, v = self._heads(layer.qkv(layer.ln1(x).to(c.compute_dtype)), 3)
        attn = flash_attention(q, k, v, causal=causal,
                               implementation=c.attention_impl)
        return x + layer.attn_proj(self._merge(attn)).to(x.dtype)

    def _cross_attention(self, layer: T5Layer, x: torch.Tensor,
                         memory: torch.Tensor) -> torch.Tensor:
        c = self.config
        (q,) = self._heads(layer.cross_q(
            layer.ln_cross(x).to(c.compute_dtype)), 1)
        k, v = self._heads(layer.cross_kv(memory.to(c.compute_dtype)), 2)
        attn = flash_attention(q, k, v, causal=False,
                               implementation=c.attention_impl)
        return x + layer.cross_proj(self._merge(attn)).to(x.dtype)

    def _mlp(self, layer: T5Layer, x: torch.Tensor) -> torch.Tensor:
        y = layer.ln2(x).to(self.config.compute_dtype)
        y = layer.fc2(F.gelu(layer.fc1(y), approximate="tanh"))
        return x + y.to(x.dtype)

    def _enc_layer(self, layer: T5Layer, x: torch.Tensor) -> torch.Tensor:
        return self._mlp(layer, self._self_attention(layer, x, causal=False))

    def _dec_layer(self, layer: T5Layer, x: torch.Tensor,
                   memory: torch.Tensor) -> torch.Tensor:
        x = self._self_attention(layer, x, causal=True)
        return self._mlp(layer, self._cross_attention(layer, x, memory))

    def _embed(self, tokens: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        if s > table.shape[0]:
            raise ValueError(f"sequence of {s} tokens past the position "
                             f"table's {table.shape[0]}")
        x = self.embedding(tokens)
        x = x + table[:s][None].to(x.dtype)
        return x.to(self.config.compute_dtype)

    def _layers(self, layers, x: torch.Tensor, body, *extra) -> torch.Tensor:
        remat = self.config.remat and torch.is_grad_enabled()
        for layer in layers:
            if remat:
                x = checkpoint(body, layer, x, *extra, use_reentrant=False)
            else:
                x = body(layer, x, *extra)
        return x

    def _final(self, norm: Norm, x: torch.Tensor) -> torch.Tensor:
        return norm(x.float()).to(self.config.compute_dtype)

    def encode(self, enc_tokens: torch.Tensor) -> torch.Tensor:
        """``(b, s_enc)`` -> encoder memory ``(b, s_enc, h)`` in the
        compute dtype."""
        x = self._embed(enc_tokens, self.enc_pos_embedding)
        unused = [p for layer in self.enc_layers
                  for p in layer.cross_parameters() if p.requires_grad]
        if unused and torch.is_grad_enabled():
            x = _ZeroGrads.apply(x, *unused)
        x = self._layers(self.enc_layers, x, self._enc_layer)
        return self._final(self.enc_final_ln, x)

    def decode(self, dec_tokens: torch.Tensor,
               memory: torch.Tensor) -> torch.Tensor:
        """``(b, s_dec)`` and the memory -> decoder hidden ``(b, s_dec,
        h)`` in the compute dtype."""
        x = self._embed(dec_tokens, self.dec_pos_embedding)
        x = self._layers(self.dec_layers, x, self._dec_layer, memory)
        return self._final(self.dec_final_ln, x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied-embedding LM head: ``(b, s, h) -> (b, s, vocab)``."""
        return torch.matmul(hidden, self.embedding.weight.to(hidden.dtype).t())

    def apply(self, enc_tokens: torch.Tensor,
              dec_tokens: torch.Tensor) -> torch.Tensor:
        """Forward to logits ``(b, s_dec, vocab)``."""
        return self.logits(self.decode(dec_tokens, self.encode(enc_tokens)))

    forward = apply

    # ----------------------------------------------------------- training
    def _per_token_ce(self, hidden: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        """Per-token CE through the tied LM head (fused or two-step, by
        ``config.fused_ce``)."""
        c = self.config
        return lm_head_cross_entropy(hidden, self.embedding.weight, targets,
                                     fused=c.fused_ce, chunk=c.fused_ce_chunk)

    def loss(self, enc_tokens: torch.Tensor, dec_tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        """Mean CE (fp32 scalar) of ``targets (b, s_dec)``; differentiable
        in every parameter (the encoder's cross-attention ones get
        zeros)."""
        hidden = self.decode(dec_tokens, self.encode(enc_tokens))
        return torch.mean(self._per_token_ce(hidden, targets))

    # ------------------------------------------------------ pipeline path
    def _pipeline(self, name: str):
        raise NotImplementedError(
            f"T5Model.{name}: pipeline schedules are not ported yet "
            "(ROADMAP.md queue A item 9)")

    def pipeline_params(self, *args: Any, **kwargs: Any):
        self._pipeline("pipeline_params")

    def pipeline_param_specs(self, *args: Any, **kwargs: Any):
        self._pipeline("pipeline_param_specs")

    def pipeline_split_stage(self, *args: Any, **kwargs: Any):
        self._pipeline("pipeline_split_stage")

    def pipeline_loss(self, *args: Any, **kwargs: Any):
        self._pipeline("pipeline_loss")

    def pipeline_grads(self, *args: Any, **kwargs: Any):
        self._pipeline("pipeline_grads")
