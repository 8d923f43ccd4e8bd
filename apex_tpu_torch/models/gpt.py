"""Megatron-style GPT: training and serving on one GPU through the port's
kernels.

Counterpart of ``apex_tpu/models/gpt.py``.  The JAX model is a factory of
pure functions over a parameter pytree with stacked layers; here it is an
``nn.Module`` whose layers are a ``ModuleList`` (``apex_tpu_torch.convert``
carries weights across both ways).  The math is kept exactly:

- the fused qkv projection's output is grouped per head,
  ``[h0_q h0_k h0_v h1_q ...]``, and split by one reshape;
- ``gelu(approximate="tanh")`` (or SwiGLU), a tied LM head;
- the residual stream runs in the compute dtype, every norm takes its
  input as given and the final norm an fp32 copy of the stream, with the
  normalized output cast to the compute dtype;
- decode clips learned positions to the table;
- ``position_embedding="rope"`` (the Llama mode, with ``rmsnorm`` and
  ``swiglu``) has no position table: q and k are rotated in every layer by
  tables computed once per forward, prefill returns K already rotated,
  and decode rotates the new K before it is cached and q inside the
  paged kernel, with rows gathered from the cached ``rope_table``.

Training draws JAX's dropout masks when ``loss``/``apply``/
``hidden_states`` get a key (``rng``, a host key of
``apex_tpu_torch.random``): it is split into one key a layer, as the JAX
layer scan does, and each layer folds in 0 for the attention-dropout seed
(through ``model_parallel_key(data_parallel_key(...))``, rank 0 each at
world size 1), 1 and 2 for the hidden dropout after the attention
projection and after the MLP.  The masks are bit-identical to JAX's
(``ops.dropout`` for hidden dropout, the attention kernels' dropout
instances for attention); remat recomputes a layer from its key, so it
replays the same masks.  Without a key dropout does nothing, as in JAX,
so serving a dropout config is serving the same weights without it.

Attention goes through ``ops.attention.flash_attention`` (the short
kernel up to 512 tokens, the mid kernel up to 2048, the flash kernels
above, all differentiable) in the forward, training and prefill, and
through ``ops.attention_decode.fmha_decode`` (the paged kernel) in
decode; every norm through ``ops.layer_norm``'s kernel.  On the CPU the
same calls run the kernels' plain versions.

Ported so far, at tensor-parallel world size 1: ``apply``, ``loss`` (the
two-step or the fused chunked LM-head cross entropy) and its backward, ``prefill_forward``,
``prefill_chunk`` (chunked prefill through the paged kernel's many-row
instance), ``decode_step``, ``verify_step`` (speculative verify of a
chain, or of a tree under the kernel's ancestor mask) and the serving of
``decode_fns`` / ``generate``, greedy or sampled (temperature, top-k,
top-p, per-slot keys): monolithic or chunked prefill, the prefix cache,
chain and tree speculation with n-gram or model drafts, the decode and
verify steps replayed as one CUDA graph per shape on the card, plus the
full-recompute ``generate_reference`` that gates greedy serving.  A
``policy`` (``apex_tpu_torch.amp``) sets the dtypes as in JAX: under O5
the parameters are bf16 and the norms' fp32, under O2 the same in fp16,
under O1 fp32 parameters compute in fp16, under O3 everything is fp16;
every level trains and serves at its compute dtype (fp16 pages, the
fp16 instances of the decode and dequant kernels).  Serving also runs
from quantized weight pools (:func:`quantize_gpt_weights`: the five
projections become ``QuantizedLinear``s over the dequant-matmul kernel,
bit-identical pools to the JAX package's) and from int8 KV pages
(``KVCacheConfig(kv_dtype=torch.int8)``).  Options that are not ported
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.amp.policy import Policy, check_ported
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.attention_decode import (
    FMHA_DECODE_MAX_ROWS,
    fmha_decode,
)
from apex_tpu_torch.ops.dequant_matmul import quantize_weight
from apex_tpu_torch.ops.dropout import dropout
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm_affine,
    fused_rms_norm_affine,
)
from apex_tpu_torch.ops.rope import apply_rope_tables, rope_cos_sin, rope_table
from apex_tpu_torch.random import fold_in, keys_tensor, seed_of, split
from apex_tpu_torch.serving.kv_cache import (
    KVCacheConfig,
    PagedKVCache,
    init_pools,
    write_targets,
    write_tokens,
)
from apex_tpu_torch.serving.graphs import StepGraph
from apex_tpu_torch.serving.sampling import (
    _check_options,
    greedy,
    sample_rows,
    spec_accept,
    spec_accept_tree,
)
from apex_tpu_torch.serving.serve import ContinuousBatcher, Request
from apex_tpu_torch.serving.speculate import (
    tree_ancestors,
    tree_depths,
    tree_max_depth,
    validate_tree,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    QuantizedLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    lm_head_cross_entropy,
    normal_init,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    data_parallel_key,
    model_parallel_key,
)
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["GPTConfig", "GPTModel", "GPTDecodeFns", "QUANTIZED_WEIGHT_LEAVES",
           "dropout_keys", "quantize_gpt_weights"]

#: options of the JAX serving entry points that the port does not take
#: yet, with the ROADMAP.md item that brings each
_UNPORTED = {
    "tp": "queue A item 9 (tensor parallelism)",
}


def _reject_unported(**options) -> None:
    for name, value in options.items():
        if value is not None and value is not False and value != 0.0:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet "
                f"(ROADMAP.md {_UNPORTED[name]})")


def dropout_keys(key):
    """A layer's dropout draws from its key, as the JAX layer makes them
    (``apex_tpu/models/gpt.py:770-821``): ``(attention seed, hidden key
    after the attention projection, hidden key after the MLP)``, the seed
    ``bits(model_parallel_key(data_parallel_key(fold_in(key, 0))))`` and
    the keys ``data_parallel_key(fold_in(key, 1 or 2))``; each helper
    folds in this process's rank, 0 at world size 1."""
    attn = model_parallel_key(data_parallel_key(fold_in(key, 0)))
    return (seed_of(attn), data_parallel_key(fold_in(key, 1)),
            data_parallel_key(fold_in(key, 2)))


def _graphed(step: Callable) -> Callable:
    """``step`` eagerly on the CPU; on a CUDA device one CUDA graph a
    step shape (:class:`~apex_tpu_torch.serving.graphs.StepGraph`, kept as
    the result's ``graph``)."""
    graph = StepGraph(step)

    def run(pools, *args):
        if pools["k"].is_cuda:
            return graph(pools, *args)
        return step(pools, *args)

    run.graph = graph
    return run


#: ``(tree, device) -> (1, R)`` int32 node depths: a constant a verify
#: step reads each call, made once (a CUDA graph cannot copy from the
#: host while it captures)
_DEPTHS: Dict[tuple, torch.Tensor] = {}


def _tree_depths(tree: tuple, device) -> torch.Tensor:
    key = (tree, torch.device(device))
    t = _DEPTHS.get(key)
    if t is None:
        t = _DEPTHS[key] = torch.as_tensor(
            tree_depths(tree), dtype=torch.int32, device=device)[None]
    return t


@dataclasses.dataclass
class GPTDecodeFns:
    """The serving steps :meth:`GPTModel.decode_fns` returns, with the
    call contract of :class:`apex_tpu_torch.serving.ContinuousBatcher`:
    ``chunk`` when built with ``prefill_chunk``, ``spec`` when built with
    ``speculate_k``.  The JAX fields ``prefill_chunk``, ``speculate_k``,
    ``spec_tree`` and ``draft_source`` are also stamped on the callables
    (``chunk.prefill_chunk``, ``spec.speculate_k``, ...), which is where
    the batcher reads them; the JAX ``*_jit`` and ``tp`` fields have no
    counterpart (tensor-parallel degree 1).  On the card ``decode`` and
    ``spec`` replay one CUDA graph per step shape
    (:class:`~apex_tpu_torch.serving.graphs.StepGraph`); ``decode_eager``
    and ``spec_eager`` are the same steps run eagerly, the counterpart of
    the JAX ``decode_jit`` seam, and on the CPU the only steps."""

    prefill: Any
    decode: Any
    eos_id: Any = None
    chunk: Any = None
    prefill_chunk: Any = None
    spec: Any = None
    speculate_k: Any = None
    spec_tree: Any = None
    draft_source: Any = None
    #: the active width of the projections every step streams:
    #: "float32"/"bf16"/"float16" for plain weights, "int8"/"int4" for
    #: quantized pools; mirrored as ``decode.weight_dtype``
    weight_dtype: Any = None
    #: bytes of every parameter and buffer one decode step reads (the
    #: JAX ``_per_chip_param_bytes`` at tp=1); mirrored as
    #: ``decode.weight_stream_bytes``
    weight_stream_bytes: Any = None
    decode_eager: Any = None
    spec_eager: Any = None


#: the projection weights :func:`quantize_gpt_weights` converts — the
#: wide matrices decode streams every token.  Embedding (tied LM head),
#: position table, norms and biases stay full precision.
QUANTIZED_WEIGHT_LEAVES = ("qkv", "attn_proj", "fc1", "fc_gate", "fc2")


def _shallow_copy(module: nn.Module) -> nn.Module:
    """A new module object over the same parameters, buffers and
    submodules, whose registries can be changed without touching
    ``module``'s."""
    new = copy.copy(module)
    for key in ("_parameters", "_buffers", "_modules"):
        new.__dict__[key] = dict(module.__dict__[key])
    return new


def _swap_projections(model: "GPTModel",
                      make: Callable[[str, nn.Module], nn.Module]):
    """A serving copy of ``model`` whose projection modules (the names of
    :data:`QUANTIZED_WEIGHT_LEAVES`) ``make(leaf_name, module)``
    replaces.  Every other parameter (embedding, position table, norms)
    is shared with ``model``, not copied."""
    out = _shallow_copy(model)
    layers = []
    for layer in model.layers:
        new = _shallow_copy(layer)
        for name in QUANTIZED_WEIGHT_LEAVES:
            mod = layer._modules.get(name)
            if mod is not None:
                new._modules[name] = make(name, mod)
        layers.append(new)
    out._modules["layers"] = nn.ModuleList(layers)
    return out


def quantize_gpt_weights(model: "GPTModel", weight_dtype: str,
                         block_size: int = 128) -> "GPTModel":
    """A serving model whose projections are quantized weight pools —
    converted ONCE, at load.

    Each projection of :data:`QUANTIZED_WEIGHT_LEAVES` becomes a
    :class:`~apex_tpu_torch.transformer.tensor_parallel.QuantizedLinear`
    over ``{"q8": int8, "scales": fp32}`` (``weight_dtype="int8"``) or
    ``{"q4": packed int8, "scales": fp32}`` (``"int4"``, the halves
    layout), block-quantized along the output features with
    ``block_size``-wide fp32 scales.  Rows are independent, so quantizing
    each layer's ``(k, n)`` matrix gives the JAX package's stacked
    ``(L*k, n)`` pools bit for bit.  Embedding, norms and biases are
    shared with ``model`` unchanged.  The pools serve at tensor-parallel
    degree 1 (``decode_fns`` rejects ``tp > 1``)."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(
            f"weight_dtype must be 'int8' or 'int4', got "
            f"{weight_dtype!r}")

    def make(name: str, mod: nn.Module) -> QuantizedLinear:
        if isinstance(mod, QuantizedLinear):
            raise ValueError(
                f"layers/{name} is already a {mod.weight_dtype} pool")
        wq = quantize_weight(mod.weight.detach(), weight_dtype, block_size,
                             leaf=f"layers/{name}.weight")
        qkey = "q8" if weight_dtype == "int8" else "q4"
        bias = None if mod.bias is None else mod.bias.detach()
        return QuantizedLinear(weight_dtype, wq[qkey], wq["scales"], bias)

    return _swap_projections(model, make)


def _bf16_projections(model: "GPTModel") -> "GPTModel":
    """A serving model whose projection weights are bf16 copies made once
    (``decode_fns(weight_dtype="bf16")``), so a bf16 step casts no
    weight; the biases stay as they are and are cast per call, as in
    JAX.  At an fp16 compute dtype (O1) every call casts the bf16 copy to
    fp16, as JAX's ``weight.astype(x.dtype)`` does."""

    def make(name: str, mod: nn.Module) -> nn.Module:
        new = _shallow_copy(mod)
        new._parameters["weight"] = nn.Parameter(
            mod.weight.detach().to(torch.bfloat16), requires_grad=False)
        return new

    return _swap_projections(model, make)


#: the JAX ``GPTConfig`` fields of the multi-GPU surface (ring attention's
#: context parallelism, mixture-of-experts) with the defaults that leave
#: them off; any other value raises
_MULTI_GPU_FIELDS = {
    "context_parallel": False, "num_experts": None, "moe_top_k": 1,
    "moe_capacity_factor": 1.25, "moe_aux_weight": 0.01,
    "moe_router_z_loss_weight": 0.0,
}


@dataclasses.dataclass
class GPTConfig:
    """Hyperparameters, as in the JAX package's ``GPTConfig``.

    ``policy`` (an ``apex_tpu_torch.amp.Policy``) overrides
    ``params_dtype``/``compute_dtype`` and keeps norm parameters fp32
    when it says so (:attr:`norm_dtype`).  ``remat`` runs each layer
    under ``torch.utils.checkpoint`` when gradients are on: the port
    saves only each layer's input and recomputes the rest, less than the
    JAX ``remat_policy`` (``dots_with_no_batch_dims_saveable``) keeps,
    with the same numbers (the recomputation is deterministic), so
    ``remat_policy`` is accepted and does not change what is saved.
    ``fused_ce`` / ``fused_ce_chunk`` pick the LM-head cross entropy as
    in JAX (None: by logits size).  ``attention_impl`` forces a rung
    (``"short"``/``"mid"``/``"pallas"``, the last the flash rung) or
    leaves the ladder to choose (None).  ``position_embedding="rope"``
    rotates q and k by ``rope_base``'s frequencies and keeps no position
    table, so ``max_position_embeddings`` then bounds nothing.
    ``hidden_dropout``/``attention_dropout`` apply only when ``loss``,
    ``apply`` or ``hidden_states`` get a key, as in JAX.

    Not ported yet: the context parallelism and mixture-of-experts fields
    (``context_parallel``, ``num_experts`` and the ``moe_*`` knobs,
    ROADMAP.md queue A item 10 (A9)): a value other than the default
    raises ``NotImplementedError``."""

    vocab_size: int = 32000
    num_layers: int = 4
    hidden_size: int = 512
    num_attention_heads: int = 8
    max_position_embeddings: int = 1024
    position_embedding: str = "learned"
    rope_base: float = 10000.0
    activation: str = "gelu"
    normalization: str = "layernorm"
    ffn_hidden_size: Optional[int] = None
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
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
    context_parallel: bool = False
    num_experts: Optional[int] = None
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_router_z_loss_weight: float = 0.0

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
        if self.position_embedding not in ("learned", "rope"):
            raise ValueError(
                f"position_embedding must be 'learned' or 'rope', got "
                f"{self.position_embedding!r}")
        if self.position_embedding == "rope" and self.head_dim % 2:
            raise ValueError("rope needs an even head_dim")
        if self.activation not in ("gelu", "swiglu"):
            raise ValueError(
                f"activation must be 'gelu' or 'swiglu', got "
                f"{self.activation!r}")
        if self.normalization not in ("layernorm", "rmsnorm"):
            raise ValueError(
                f"normalization must be 'layernorm' or 'rmsnorm', got "
                f"{self.normalization!r}")
        for name in ("hidden_dropout", "attention_dropout"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got "
                                 f"{getattr(self, name)!r}")
        for name, default in _MULTI_GPU_FIELDS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: context parallelism "
                    "and mixture-of-experts are not ported yet (ROADMAP.md "
                    "queue A item 10, A9)")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def norm_dtype(self) -> torch.dtype:
        """Norm parameter dtype: fp32 under a keep-norm-fp32 policy."""
        if self.policy is not None and self.policy.keep_norm_fp32:
            return torch.float32
        return self.params_dtype


class Norm(nn.Module):
    """ln1/ln2/final_ln: fused LayerNorm (``scale`` + ``bias``) or RMSNorm
    (``scale`` only), fp32 statistics either way."""

    def __init__(self, hidden: int, normalization: str, eps: float,
                 dtype: torch.dtype, device):
        super().__init__()
        self.hidden = hidden
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(hidden, dtype=dtype,
                                             device=device))
        if normalization == "layernorm":
            self.bias = nn.Parameter(torch.zeros(hidden, dtype=dtype,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return fused_rms_norm_affine(x, self.scale, self.hidden,
                                         eps=self.eps)
        return fused_layer_norm_affine(x, self.scale, self.bias,
                                       self.hidden, eps=self.eps)


class GPTLayer(nn.Module):
    """One transformer layer's parameters (the JAX ``layers`` subtree at
    one index of the stacked dim)."""

    def __init__(self, c: GPTConfig, device, generator):
        super().__init__()
        init = normal_init(c.init_method_std)
        # Megatron output-layer init: std / sqrt(2 * L)
        out_init = normal_init(c.init_method_std / math.sqrt(2.0 * c.num_layers))
        kw = dict(params_dtype=c.params_dtype, device=device,
                  generator=generator)

        def norm():
            return Norm(c.hidden_size, c.normalization, c.layernorm_epsilon,
                        c.norm_dtype, device)

        self.ln1 = norm()
        self.qkv = ColumnParallelLinear(c.hidden_size, 3 * c.hidden_size,
                                        init_method=init, **kw)
        self.attn_proj = RowParallelLinear(c.hidden_size, c.hidden_size,
                                           init_method=out_init, **kw)
        self.ln2 = norm()
        self.fc1 = ColumnParallelLinear(c.hidden_size, c.ffn_hidden_size,
                                        init_method=init, **kw)
        if c.activation == "swiglu":
            self.fc_gate = ColumnParallelLinear(
                c.hidden_size, c.ffn_hidden_size, init_method=init, **kw)
        else:
            self.fc_gate = None
        self.fc2 = RowParallelLinear(c.ffn_hidden_size, c.hidden_size,
                                     init_method=out_init, **kw)


class GPTModel(nn.Module):
    """Decoder-only transformer LM.

    ``device`` defaults to the GPU (and raises without one); pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels.
    Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    (load JAX weights with :func:`apex_tpu_torch.convert.params_from_jax`
    and ``load_state_dict``)."""

    def __init__(self, config: GPTConfig, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init = normal_init(c.init_method_std)
        self.embedding = VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, init_method=init,
            params_dtype=c.params_dtype, device=self.device, generator=gen)
        if c.position_embedding == "learned":
            self.pos_embedding = nn.Parameter(torch.empty(
                (c.max_position_embeddings, c.hidden_size),
                dtype=c.params_dtype, device=self.device))
            init(self.pos_embedding, gen)
        else:
            # a rope model has no position table (nor a JAX leaf for one)
            self.register_parameter("pos_embedding", None)
        self.layers = nn.ModuleList(
            GPTLayer(c, self.device, gen) for _ in range(c.num_layers))
        self.final_ln = Norm(c.hidden_size, c.normalization,
                             c.layernorm_epsilon, c.norm_dtype,
                             self.device)

    # ------------------------------------------------------------ forward
    def _qkv_heads(self, layer: GPTLayer, y: torch.Tensor):
        """(b, s, h) normed activations -> (q, k, v), each ``(b, heads, s,
        head_dim)``, from the per-head-grouped qkv output."""
        c = self.config
        b, s, _ = y.shape
        qkv = layer.qkv(y).reshape(b, s, c.num_attention_heads, 3,
                                   c.head_dim)
        return tuple(qkv[:, :, :, i].transpose(1, 2) for i in range(3))

    def _dense_mlp(self, layer: GPTLayer, y: torch.Tensor) -> torch.Tensor:
        if layer.fc_gate is not None:
            y = F.silu(layer.fc_gate(y)) * layer.fc1(y)
        else:
            y = F.gelu(layer.fc1(y), approximate="tanh")
        return layer.fc2(y)

    def _layer(self, layer: GPTLayer, x: torch.Tensor, rope=None,
               key=None):
        """One layer over ``x (b, s, h)``: returns the layer output and
        the attention-ready ``k``/``v`` ``(b, heads, s, head_dim)``, k
        rotated by ``rope`` (the ``(cos, sin)`` of :meth:`_rope_tables`,
        None for learned positions).  ``key`` (this layer's, or None)
        turns on the config's dropout, with the JAX layer's key schedule
        (``apex_tpu/models/gpt.py:763-822``)."""
        c = self.config
        b, s, _ = x.shape
        residual = x
        y = layer.ln1(x).to(c.compute_dtype)
        q, k, v = self._qkv_heads(layer, y)
        if rope is not None:
            q = apply_rope_tables(q, *rope)
            k = apply_rope_tables(k, *rope)
        if key is None:       # no key, no dropout (rate 0 is the identity)
            attn_rate = hidden_rate = 0.0
            seed = key1 = key2 = None
        else:
            attn_rate, hidden_rate = c.attention_dropout, c.hidden_dropout
            seed, key1, key2 = dropout_keys(key)
        attn = flash_attention(q, k, v, causal=True,
                               dropout_rate=attn_rate, dropout_seed=seed,
                               implementation=c.attention_impl)
        attn = attn.transpose(1, 2).reshape(b, s, c.hidden_size)
        out = dropout(layer.attn_proj(attn), key1, hidden_rate)
        x = residual + out.to(residual.dtype)
        residual = x
        y = self._dense_mlp(layer, layer.ln2(x).to(c.compute_dtype))
        y = dropout(y, key2, hidden_rate)
        return residual + y.to(residual.dtype), k, v

    def _layer_out(self, layer: GPTLayer, x: torch.Tensor, rope=None,
                   key=None) -> torch.Tensor:
        return self._layer(layer, x, rope, key)[0]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embedding plus, for learned positions, the table's rows;
        a rope model adds nothing here."""
        x = self.embedding(tokens)
        if self.pos_embedding is not None:
            s = tokens.shape[1]
            x = x + self.pos_embedding[:s][None].to(x.dtype)
        return x.to(self.config.compute_dtype)

    def _rope_tables(self, s: int):
        """``(cos, sin)`` of positions ``0..s-1`` for a rope model, once
        per forward (every layer and the remat recompute reuse them);
        None for learned positions."""
        c = self.config
        if c.position_embedding != "rope":
            return None
        return rope_cos_sin(torch.arange(s, device=self.device), c.head_dim,
                            c.rope_base)

    def _final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_ln(x.float()).to(self.config.compute_dtype)

    def hidden_states(self, tokens: torch.Tensor,
                      rng=None) -> torch.Tensor:
        """Embed, run all layers, final norm: ``(b, s, h)`` hidden in the
        compute dtype (the JAX version also returns the MoE aux loss,
        which a dense model does not have).  ``rng``, a key of
        :mod:`apex_tpu_torch.random` (or None), is split into one key a
        layer for dropout; the remat recompute gets the same key."""
        x = self._embed(tokens)
        rope = self._rope_tables(tokens.shape[1])
        remat = self.config.remat and torch.is_grad_enabled()
        keys = ([None] * len(self.layers) if rng is None
                else list(split(rng, len(self.layers))))
        for layer, key in zip(self.layers, keys):
            if remat:
                x = checkpoint(self._layer_out, layer, x, rope, key,
                               use_reentrant=False)
            else:
                x = self._layer_out(layer, x, rope, key)
        return self._final_norm(x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied-embedding LM head: ``(..., h) -> (..., vocab)``."""
        w = self.embedding.weight.to(hidden.dtype)
        return torch.matmul(hidden, w.t())

    def apply(self, tokens: torch.Tensor, rng=None) -> torch.Tensor:
        """Forward to logits ``(b, s, vocab)``; ``rng`` turns dropout on."""
        return self.logits(self.hidden_states(tokens, rng))

    forward = apply

    # ----------------------------------------------------------- training
    def _per_token_ce(self, hidden: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
        """Per-token CE through the tied LM head (the two-step path or
        the fused chunked one, by ``config.fused_ce``; None: by logits
        size)."""
        return lm_head_cross_entropy(
            hidden, self.embedding.weight, targets,
            fused=self.config.fused_ce, chunk=self.config.fused_ce_chunk)

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             rng=None) -> torch.Tensor:
        """Mean next-token CE (fp32 scalar) over ``tokens``/``targets``
        ``(b, s)``; differentiable in every parameter.  ``rng`` (a key of
        :mod:`apex_tpu_torch.random`, or None) turns dropout on."""
        return torch.mean(self._per_token_ce(
            self.hidden_states(tokens, rng), targets))

    # ------------------------------------------------- serving / decode
    def _weight_pool_dtype(self) -> str:
        """The active weight width the projections imply: ``"int8"`` /
        ``"int4"`` for quantized pools, the storage dtype name
        (``"float32"``/``"bf16"``/``"float16"``, JAX's ``str(dtype)``)
        otherwise."""
        for layer in self.layers[:1]:
            for name in QUANTIZED_WEIGHT_LEAVES:
                mod = layer._modules.get(name)
                if mod is None:
                    continue
                if isinstance(mod, QuantizedLinear):
                    return mod.weight_dtype
                d = mod.weight.dtype
                return ("bf16" if d == torch.bfloat16
                        else str(d).replace("torch.", ""))
        return "float32"

    def _check_weight_dtype(self, weight_dtype: Optional[str]) -> None:
        """A step invoked with a ``weight_dtype=`` claim that disagrees
        with the projections raises instead of serving the wrong
        numerics contract."""
        if weight_dtype is None:
            return
        want = {"fp32": "float32", "bfloat16": "bf16"}.get(
            weight_dtype, weight_dtype)
        have = self._weight_pool_dtype()
        if want != have:
            raise ValueError(
                f"weight_dtype={weight_dtype!r} declared but the "
                f"params carry {have} weights — quantize with "
                f"quantize_gpt_weights (or drop the declaration)")

    def weight_stream_bytes(self) -> int:
        """Bytes of every parameter and buffer one decode step reads: the
        JAX package's ``_per_chip_param_bytes`` at tp=1 (each shared
        tensor once)."""
        tensors = {id(t): t for t in list(self.parameters())
                   + list(self.buffers())}
        return int(sum(t.numel() * t.element_size()
                       for t in tensors.values()))

    def prefill_forward(self, tokens: torch.Tensor):
        """Prompt ingestion over ``tokens (b, s)`` through the attention
        ladder, also returning each layer's K/V for the cache write:
        ``(hidden (b, s, h), k, v)`` with k/v ``(num_layers, b, heads, s,
        head_dim)``, K already rotated for a rope model (a cached key is
        rotated once; decode rotates only q)."""
        x = self._embed(tokens)
        rope = self._rope_tables(tokens.shape[1])
        ks, vs = [], []
        for layer in self.layers:
            x, k, v = self._layer(layer, x, rope)
            ks.append(k)
            vs.append(v)
        return self._final_norm(x), torch.stack(ks), torch.stack(vs)

    def decode_step(
        self,
        tokens: torch.Tensor,
        positions: torch.Tensor,
        active: torch.Tensor,
        page_table: torch.Tensor,
        pools: Dict[str, torch.Tensor],
        *,
        quantized: bool = False,
        kv_block: int = 128,
        weight_dtype: Optional[str] = None,
    ):
        """ONE decode step for a fixed batch of serving slots.  ``tokens
        (S,)`` are the current tokens, each at 0-based ``positions[s]``;
        ``active (S,)`` masks live slots (idle slots compute garbage and
        write it to the null page).  Every layer writes its new K/V into
        its pool slice first (the token attends to itself) and then runs
        :func:`fmha_decode` against the paged cache.  A rope model
        rotates the new K before it is written and hands the kernel this
        step's ``(S, 1, head_dim/2)`` rows of the cached ``rope_table``
        (over the cache's whole extent) to rotate q.  ``quantized`` pools
        are int8 pages with their scales (``kv_block`` dims a scale);
        ``weight_dtype`` declares the projections' width and raises if it
        disagrees.  Returns ``(logits (S, vocab), pools)``; the pools are
        updated in place."""
        self._check_weight_dtype(weight_dtype)
        page_size = pools["k"].shape[3]
        positions = positions.to(torch.int32)
        x = self._embed_at(tokens[:, None], positions[:, None])
        rope_cs = self._rope_rows(positions[:, None],
                                  page_table.shape[1] * page_size)
        attend = torch.where(active, positions + 1, 0).to(torch.int32)
        wp, wo = write_targets(page_table, positions, active, page_size)
        x, _, _ = self._paged_layers(x, pools, page_table, attend, wp, wo,
                                     rope_cs, quantized, kv_block)
        return self.logits(x)[:, 0], pools

    def _embed_at(self, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """Token embedding plus, for learned positions, the table's rows
        at ``positions`` (clipped to the table, as JAX's take does), in
        the compute dtype."""
        c = self.config
        x = self.embedding(tokens)
        if self.pos_embedding is not None:
            pos = positions.clamp(0, c.max_position_embeddings - 1).long()
            x = x + self.pos_embedding[pos].to(x.dtype)
        return x.to(c.compute_dtype)

    def _rope_rows(self, positions: torch.Tensor, extent: int):
        """For a rope model, ``(cos, sin)`` rows of the cached
        ``rope_table`` over the cache's ``extent`` at ``positions (b,
        s)`` (clipped, as JAX's take does): ``(b, s, head_dim/2)`` each,
        the paged kernel's q-rotation operand.  None for learned
        positions."""
        c = self.config
        if self.pos_embedding is not None:
            return None
        cos_t, sin_t = rope_table(extent, c.head_dim, base=c.rope_base,
                                  device=positions.device)
        pos = positions.clamp(0, extent - 1).long()
        return cos_t[pos], sin_t[pos]

    def _paged_layers(self, x, pools, page_table, attend, wp, wo, rope_cs,
                      quantized, kv_block, ancestor=None):
        """Every layer over ``x (b, s, h)`` against the paged cache,
        write-before-attend: each layer scatters its new K/V rows to
        ``(wp, wo)`` (``(b, s)`` or ``(b*s,)`` targets) in its pool slice
        (in place), then runs :func:`fmha_decode` over ``page_table`` and
        ``attend`` lengths.  Returns ``(final-normed hidden, ks, vs)``,
        the per-layer attention-ready K/V ``(b, heads, s, head_dim)`` (K
        rotated for a rope model)."""
        c = self.config
        b, s, _ = x.shape
        wp, wo = wp.reshape(-1), wo.reshape(-1)
        ks, vs = [], []
        for li, layer in enumerate(self.layers):
            pool_l = {name: pool[li] for name, pool in pools.items()}
            residual = x
            y = layer.ln1(x).to(c.compute_dtype)
            q, k, v = self._qkv_heads(layer, y)          # (b, h, s, d)
            if rope_cs is not None:
                k = apply_rope_tables(k, rope_cs[0][:, None],
                                      rope_cs[1][:, None])
            ks.append(k)
            vs.append(v)
            write_tokens(pool_l, k.transpose(1, 2).reshape(b * s, -1,
                                                          c.head_dim),
                         v.transpose(1, 2).reshape(b * s, -1, c.head_dim),
                         wp, wo, quantized=quantized, kv_block=kv_block)
            attn = fmha_decode(q, pool_l["k"], pool_l["v"], page_table,
                               attend, causal=True,
                               k_scales=pool_l.get("k_scales"),
                               v_scales=pool_l.get("v_scales"),
                               kv_block=kv_block, rope=rope_cs,
                               ancestor=ancestor)
            attn = attn.transpose(1, 2).reshape(b, s, c.hidden_size)
            x = residual + layer.attn_proj(attn).to(residual.dtype)
            residual = x
            y = layer.ln2(x).to(c.compute_dtype)
            x = residual + self._dense_mlp(layer, y).to(residual.dtype)
        return self._final_norm(x), ks, vs

    def prefill_chunk(
        self,
        tokens: torch.Tensor,
        start: int,
        prompt_len: int,
        write_from: int,
        page_row: torch.Tensor,
        pools: Dict[str, torch.Tensor],
        *,
        quantized: bool = False,
        kv_block: int = 128,
        weight_dtype: Optional[str] = None,
    ):
        """ONE fixed-size prompt-ingestion chunk for one serving slot (the
        Sarathi-style alternative to :meth:`prefill_forward` that lets the
        scheduler interleave prompt work with decode steps).  ``tokens
        (1, C)`` are prompt ids at positions ``start .. start + C`` (rows
        at or past ``prompt_len`` are padding); each layer writes the
        chunk's K/V into the slot's pages (positions below ``write_from``,
        a prefix-cache hit's shared region, go to the null page instead)
        and attends over the cache INCLUDING its own just-written rows
        through :func:`fmha_decode` at ``sq = C``, each row causal at its
        position.  Returns ``(logits (vocab,), pools)``: the logits of the
        last valid prompt row (``prompt_len - 1``, clipped into this
        chunk); the pools are updated in place.

        Chunk boundaries are absolute (chunk ``k`` covers ``[k*C,
        (k+1)*C)``) and attention reads K/V from the pools, so a
        prefix-cache hit that skips matched chunks gives logits
        bit-identical to a cold admission's."""
        self._check_weight_dtype(weight_dtype)
        C = tokens.shape[-1]
        tokens = tokens.reshape(1, C)
        page_size = pools["k"].shape[3]
        start, prompt_len = int(start), int(prompt_len)
        positions = start + torch.arange(C, dtype=torch.int32,
                                         device=tokens.device)
        valid = positions < prompt_len
        writev = valid & (positions >= int(write_from))
        x = self._embed_at(tokens, positions[None])
        rope_cs = self._rope_rows(positions[None],
                                  page_row.shape[0] * page_size)
        # the chunk attends over start + C cache positions: padding rows
        # see (and make) garbage, a valid row stops at its own position
        attend = torch.full((1,), start + C, dtype=torch.int32,
                            device=tokens.device)
        wp, wo = write_targets(page_row, positions, writev, page_size)
        x, _, _ = self._paged_layers(x, pools, page_row[None], attend, wp,
                                     wo, rope_cs, quantized, kv_block)
        last_row = min(max(prompt_len - 1 - start, 0), C - 1)
        return self.logits(x[0, last_row]), pools

    def verify_step(
        self,
        tokens: torch.Tensor,
        lengths: torch.Tensor,
        active: torch.Tensor,
        valid: torch.Tensor,
        page_table: torch.Tensor,
        pools: Dict[str, torch.Tensor],
        *,
        quantized: bool = False,
        kv_block: int = 128,
        weight_dtype: Optional[str] = None,
        tree: Optional[tuple] = None,
    ):
        """ONE speculative verify step: :meth:`decode_step` widened to ``R
        = k + 1`` rows per slot, one weight stream for all of them.
        ``tokens (S, R)`` are each slot's current token and its k drafts
        at positions ``lengths[s] .. lengths[s] + R - 1``; ``valid (S,
        R)`` masks the real rows (padding rows write to the null page, as
        do rows past the slot's page extent).  Each layer writes the rows'
        K/V first and attends through :func:`fmha_decode` at ``sq = R``,
        row i seeing the committed cache and rows 0..i.  Returns
        ``(logits (S, R, vocab), pools)``: row j predicts the token after
        j committed drafts.

        ``tree`` (a static ``parents`` tuple of length R,
        :mod:`apex_tpu_torch.serving.speculate`) verifies a candidate tree
        instead: row r embeds and rotates at its LOGICAL position
        ``lengths + depth(r)`` while its K/V lands at the PHYSICAL slot
        ``lengths + r``, and attention runs under the tree's ancestor
        mask.  Returns ``(logits, pools, (ks, vs))`` then, the per-layer
        post-RoPE K/V rows ``(L, S, heads, R, head_dim)`` at full width,
        for the caller's rewrite of the accepted path to its depth
        positions (re-quantizing dequantized int8 pages would not give
        the same bytes)."""
        self._check_weight_dtype(weight_dtype)
        S, R = tokens.shape
        page_size = pools["k"].shape[3]
        lengths = lengths.to(torch.int32)
        rows = torch.arange(R, dtype=torch.int32, device=tokens.device)
        positions = lengths[:, None] + rows[None]
        max_len = page_table.shape[1] * page_size
        writev = valid & active[:, None] & (positions < max_len)
        ancestor, logical = None, positions
        if tree is not None:
            tree = tuple(int(p) for p in tree)
            if len(tree) != R:
                raise ValueError(
                    f"tree has {len(tree)} rows but tokens carry {R} — "
                    "the parents tuple must cover every verify row")
            ancestor = tree_ancestors(tree)
            logical = lengths[:, None] + _tree_depths(tree, tokens.device)
        x = self._embed_at(tokens, logical)
        rope_cs = self._rope_rows(logical, max_len)
        attend = torch.where(active, lengths + R, 0).to(torch.int32)
        wp, wo = write_targets(page_table, positions, writev, page_size)
        x, ks, vs = self._paged_layers(x, pools, page_table, attend, wp, wo,
                                       rope_cs, quantized, kv_block,
                                       ancestor=ancestor)
        logits = self.logits(x)
        if tree is not None:
            return logits, pools, (torch.stack(ks), torch.stack(vs))
        return logits, pools

    def decode_fns(
        self,
        cache_config,
        *,
        max_prompt_len: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        speculate_k: Optional[int] = None,
        spec_tree: Optional[tuple] = None,
        draft_model: Optional[Any] = None,
        weight_dtype: Optional[str] = None,
        weight_block: int = 128,
        tp: Optional[int] = None,
    ) -> GPTDecodeFns:
        """Build the serving steps
        :class:`apex_tpu_torch.serving.ContinuousBatcher` drives:
        ``prefill(pools, tokens (1, max_prompt_len), length, page_row,
        key) -> (pools, first_token)`` and ``decode(pools, carry,
        page_table) -> (pools, carry)``; with ``prefill_chunk=C`` also
        ``chunk(pools, tokens (C,), start, prompt_len, write_from,
        page_row, key) -> (pools, first_token, logits)``
        (:meth:`prefill_chunk`, the stall-free scheduler's step); with
        ``speculate_k=K`` also ``spec(pools, carry, page_table, drafts (S,
        K), draft_len (S,)) -> (pools, carry, targets (S, K+1), n_commit
        (S,))``: :meth:`verify_step` at ``K + 1`` rows, :func:`~apex_tpu_torch.serving.sampling
        .spec_accept` and a multi-token commit of the carry.
        ``spec_tree`` (a static ``parents`` tuple, e.g.
        :func:`~apex_tpu_torch.serving.speculate.offramp_tree`) makes
        ``spec`` a tree verify (drafts ``(S, R-1)``, returning ``path``
        too): the rows attend under the tree's ancestor mask, the walk of
        :func:`~apex_tpu_torch.serving.sampling.spec_accept_tree` picks
        the accepted path, and the path's K/V rows are rewritten from
        their physical rows to their depth positions from the full-width
        values, so the cache is what plain decode would have written.
        ``draft_model`` (a :class:`~apex_tpu_torch.serving.speculate
        .ModelDraftSource`) rides on ``spec`` to the batcher.  Every step
        runs without autograd, updates the pools in place and syncs with
        the host only where the batcher reads a result.  Int8 KV pages
        (``cache_config.quantized``) are written quantized by every step.

        ``weight_dtype`` sets the width of the weights every step streams,
        converted ONCE here: ``"int8"``/``"int4"`` quantize the
        projections (:func:`quantize_gpt_weights`, block size
        ``weight_block``) and the steps run the dequant-matmul kernel;
        ``"bf16"`` makes bf16 copies of fp32 projection weights, so no bf16
        step casts a weight (at O1, fp16 compute, each step casts the bf16
        copies to fp16, JAX's ``weight.astype(x.dtype)``); ``None`` serves
        the model as given, including a model :func:`quantize_gpt_weights`
        already converted (a declared width must match it).  The active width and the weight-stream
        bytes are stamped on the result and on ``decode``.

        ``temperature > 0`` samples (:func:`~apex_tpu_torch.serving
        .sampling.sample`'s chain, floored by ``top_k``/``top_p``) with
        JAX's key schedule: each draw folds a context length into the
        slot's key, the prefill and the chunk ``length``/``prompt_len``
        into the ``key`` they are given, the decode step ``lengths + 1``
        into the carry's ``sample_keys`` row, a chain verify row ``j``
        ``lengths + 1 + j`` and a tree node ``lengths + 1 + depth``, so
        every path commits the plain sampled stream.

        On a CUDA device ``decode`` and ``spec`` replay one CUDA graph per
        step shape (:class:`~apex_tpu_torch.serving.graphs.StepGraph`:
        the first call runs eagerly and captures); a replay's outputs are
        static buffers that the next replay overwrites.  ``decode_eager``
        and ``spec_eager`` on the result are the eager steps."""
        _check_options(temperature, top_k, top_p)
        _reject_unported(tp=None if tp == 1 else tp)
        c = self.config
        if draft_model is not None:
            if speculate_k is None:
                raise ValueError(
                    "draft_model given without speculate_k — the draft "
                    "model drafts k tokens per verify window; pass "
                    "speculate_k=K")
            if not callable(getattr(draft_model, "draft", None)):
                raise TypeError(
                    "draft_model must be a DraftSource (a .draft "
                    "method) — build one with "
                    "apex_tpu_torch.serving.speculate.ModelDraftSource")
            dk = getattr(draft_model, "k", None)
            if dk is not None and int(dk) != int(speculate_k):
                raise ValueError(
                    f"draft_model drafts k={dk} but speculate_k="
                    f"{speculate_k} — the draft budget and the verify "
                    "row count must agree")
            dtree = getattr(draft_model, "tree", None)
            if dtree is not None and spec_tree is not None and \
                    tuple(int(p) for p in dtree) != \
                    tuple(int(p) for p in spec_tree):
                raise ValueError(
                    "draft_model was built for a different candidate "
                    f"tree ({tuple(dtree)}) than spec_tree="
                    f"{tuple(spec_tree)} — the drafter's row layout "
                    "and the verify step's ancestor mask must match")
        cfg = cache_config
        if (cfg.num_layers != c.num_layers
                or cfg.num_heads != c.num_attention_heads
                or cfg.head_dim != c.head_dim):
            raise ValueError(
                f"cache config (L={cfg.num_layers}, h={cfg.num_heads}, "
                f"d={cfg.head_dim}) does not match the model "
                f"(L={c.num_layers}, h={c.num_attention_heads}, "
                f"d={c.head_dim})")
        if c.position_embedding == "learned" and (
                max(cfg.max_len, max_prompt_len)
                > c.max_position_embeddings):
            raise ValueError(
                f"cache holds up to {cfg.max_len} positions and prompts up "
                f"to {max_prompt_len} tokens but the learned table stops at "
                f"{c.max_position_embeddings}")
        if cfg.dtype != c.compute_dtype:
            raise ValueError(
                f"cache pages are {cfg.dtype} but the model computes in "
                f"{c.compute_dtype}: the decode kernel reads pages in the "
                "query's dtype")
        if weight_dtype is not None and weight_dtype not in (
                "bf16", "int8", "int4"):
            raise ValueError(
                f"weight_dtype must be None, 'bf16', 'int8' or "
                f"'int4', got {weight_dtype!r}")
        if prefill_chunk is not None:
            if int(prefill_chunk) < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if int(prefill_chunk) > FMHA_DECODE_MAX_ROWS:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} exceeds the decode "
                    f"kernel's per-program row budget "
                    f"(FMHA_DECODE_MAX_ROWS={FMHA_DECODE_MAX_ROWS}); "
                    "use a smaller chunk")
        if spec_tree is not None and speculate_k is None:
            raise ValueError(
                "spec_tree given without speculate_k — the tree's max "
                "depth IS the draft budget; pass speculate_k=K")
        tree = None
        if speculate_k is not None:
            K = int(speculate_k)
            if K < 1:
                raise ValueError(
                    f"speculate_k must be >= 1, got {speculate_k}")
            if K + 1 > FMHA_DECODE_MAX_ROWS:
                raise ValueError(
                    f"speculate_k {K} puts the verify step at "
                    f"{K + 1} rows, past the decode kernel's "
                    f"per-program row budget "
                    f"(FMHA_DECODE_MAX_ROWS={FMHA_DECODE_MAX_ROWS})")
            if spec_tree is not None:
                tree = validate_tree(spec_tree)
                if tree_max_depth(tree) != K:
                    raise ValueError(
                        f"spec_tree has max depth {tree_max_depth(tree)} "
                        f"but speculate_k={K} — the deepest root-to-leaf "
                        "path is the draft budget; they must agree")
        model = self
        wd_in = self._weight_pool_dtype()
        if weight_dtype in ("int8", "int4"):
            if wd_in in ("int8", "int4"):
                if wd_in != weight_dtype:
                    raise ValueError(
                        f"weight_dtype={weight_dtype!r} requested but "
                        f"the params already carry a {wd_in} pool")
            else:
                model = quantize_gpt_weights(self, weight_dtype,
                                             weight_block)
        elif weight_dtype == "bf16" and wd_in == "float32":
            model = _bf16_projections(self)
        wd_active = model._weight_pool_dtype()
        kv = dict(quantized=cfg.quantized, kv_block=cfg.kv_block)
        sampled = temperature > 0.0

        def first_token(logits, key, ctx: int):
            """The draw after ``ctx`` context tokens from one row of
            logits: ``fold_in(key, ctx)`` when sampling."""
            if not sampled:
                return greedy(logits)
            if key is None:
                raise ValueError("temperature > 0 requires a PRNG key")
            ctx_t = torch.full((1,), int(ctx), dtype=torch.int32,
                               device=logits.device)
            return sample_rows(logits[None], keys_tensor(key, logits.device),
                               ctx_t, temperature, top_k, top_p)[0]

        @torch.no_grad()
        def prefill(pools, toks, length: int, page_row, key=None):
            hidden, ks, vs = model.prefill_forward(toks)
            pos = torch.arange(toks.shape[1], device=toks.device)
            wp, wo = write_targets(page_row, pos, pos < length,
                                   cfg.page_size)
            for li in range(c.num_layers):
                # (1, h, s, d) -> (s, h, d) token rows
                write_tokens({name: pool[li] for name, pool in pools.items()},
                             ks[li, 0].transpose(0, 1),
                             vs[li, 0].transpose(0, 1), wp, wo, **kv)
            last = hidden[0, length - 1]
            return pools, first_token(model.logits(last), key, length)

        def freeze(carry, active, tokens, n_c, is_eos):
            """The carry after a step that commits ``n_c (S,)`` tokens a
            live slot, ``tokens`` the last of them: the freeze rules of
            the one-token step (EOS committed, or budget spent)."""
            steps_left = carry["steps_left"] - n_c
            done = carry["done"] | (active & (is_eos | (steps_left <= 0)))
            return {
                "tokens": torch.where(active, tokens, carry["tokens"]),
                "lengths": carry["lengths"] + n_c,
                "steps_left": steps_left,
                "done": done,
                "sample_keys": carry["sample_keys"],
            }

        @torch.no_grad()
        def decode_eager(pools, carry, page_table):
            active = ~carry["done"]
            logits, pools = model.decode_step(
                carry["tokens"], carry["lengths"], active, page_table,
                pools, **kv)
            if sampled:
                ctx = torch.where(active, carry["lengths"] + 1, 0)
                tokens = sample_rows(logits, carry["sample_keys"], ctx,
                                     temperature, top_k, top_p)
            else:
                tokens = greedy(logits)
            eos_hit = ((tokens == eos_id) if eos_id is not None
                       else torch.zeros_like(active))
            return pools, freeze(carry, active, tokens,
                                 active.to(torch.int32), eos_hit)

        decode = _graphed(decode_eager)

        chunk = None
        if prefill_chunk is not None:
            C = int(prefill_chunk)

            @torch.no_grad()
            def chunk(pools, toks, start, plen, write_from, row, key=None):
                toks = torch.as_tensor(np.asarray(toks, np.int32),
                                       device=row.device).reshape(1, C)
                logits, pools = model.prefill_chunk(
                    toks, start, plen, write_from, row, pools, **kv)
                return pools, first_token(logits, key, plen), logits

            # the batcher schedules chunks of ITS size and must reject a
            # step built for another
            chunk.prefill_chunk = C

        def commit(carry, active, outs, n_acc):
            """Accepted drafts plus the correction/bonus row, cut at the
            first committed EOS and capped at the remaining budget."""
            R = outs.shape[1]
            jrow = torch.arange(R, device=outs.device)[None]
            raw = n_acc + 1
            is_eos = ((outs == eos_id) if eos_id is not None
                      else torch.zeros_like(outs, dtype=torch.bool))
            eos_run = is_eos & (jrow < raw[:, None])
            first_eos = torch.argmax(eos_run.to(torch.int32), dim=1)
            n_c = torch.where(eos_run.any(dim=1), first_eos + 1, raw)
            n_c = torch.minimum(n_c, carry["steps_left"])
            n_c = torch.where(active, n_c, 0).to(torch.int32)
            last = torch.gather(outs, 1, (n_c.long() - 1).clamp(
                0, R - 1)[:, None])[:, 0]
            eos_committed = (is_eos & (jrow < n_c[:, None])).any(dim=1)
            return freeze(carry, active, last, n_c, eos_committed), n_c

        spec = spec_eager = None
        if speculate_k is not None:
            K = int(speculate_k)
            R = K + 1 if tree is None else len(tree)

            def step_keys(carry, active, offsets):
                """Each verify row's key and context: the slot key, folded
                in the kernel with ``lengths + 1 + offsets`` (the row's
                position in a chain, the node's depth in a tree)."""
                if not sampled:
                    return None, None
                ctx = torch.where(active[:, None],
                                  carry["lengths"][:, None] + 1 + offsets, 0)
                return carry["sample_keys"][:, None, :], ctx

            if tree is None:
                @torch.no_grad()
                def spec_body(pools, carry, page_table, drafts, draft_len):
                    active = ~carry["done"]
                    rows = torch.cat([carry["tokens"][:, None], drafts],
                                     dim=1)
                    jrow = torch.arange(K + 1, dtype=torch.int32,
                                        device=rows.device)[None]
                    valid = jrow <= draft_len[:, None]
                    logits, pools = model.verify_step(
                        rows, carry["lengths"], active, valid, page_table,
                        pools, **kv)
                    keys, ctx = step_keys(carry, active, jrow)
                    targets, n_acc = spec_accept(
                        logits, drafts, draft_len, keys, temperature, top_k,
                        top_p, ctx=ctx)
                    carry, n_c = commit(carry, active, targets, n_acc)
                    return pools, carry, targets, n_c
            else:
                @torch.no_grad()
                def spec_body(pools, carry, page_table, drafts, draft_len):
                    active = ~carry["done"]
                    rows = torch.cat([carry["tokens"][:, None], drafts],
                                     dim=1)
                    dev = rows.device
                    lengths = carry["lengths"]
                    jrow = torch.arange(R, dtype=torch.int32,
                                        device=dev)[None]
                    jd = _tree_depths(tree, dev)
                    max_len = page_table.shape[1] * cfg.page_size
                    # a node is live when its depth fits the drafted length
                    # AND its physical row fits the slot's page extent
                    valid = (jd <= draft_len[:, None]) & (
                        lengths[:, None] + jrow < max_len)
                    logits, pools, (ks, vs) = model.verify_step(
                        rows, lengths, active, valid, page_table, pools,
                        tree=tree, **kv)
                    keys, ctx = step_keys(carry, active, jd)
                    outs, n_acc, path = spec_accept_tree(
                        logits, drafts, tree, valid[:, 1:], keys,
                        temperature, top_k, top_p, ctx=ctx)
                    new_carry, n_c = commit(carry, active, outs, n_acc)
                    # pass 2: depth d's committed node (row path[d]) moves
                    # to position lengths + d, from the full-width K/V
                    dst = lengths[:, None] + jrow
                    rw = (active[:, None] & (jrow >= 1)
                          & (jrow <= n_acc[:, None]) & (dst < max_len))
                    wp2, wo2 = write_targets(page_table, dst, rw,
                                             cfg.page_size)
                    S = rows.shape[0]
                    idx = path.long()[:, None, :, None].expand(
                        S, ks.shape[2], R, ks.shape[4])
                    for li in range(c.num_layers):
                        kl = torch.gather(ks[li], 2, idx)
                        vl = torch.gather(vs[li], 2, idx)
                        write_tokens(
                            {name: pool[li] for name, pool in pools.items()},
                            kl.transpose(1, 2).reshape(S * R, -1, c.head_dim),
                            vl.transpose(1, 2).reshape(S * R, -1, c.head_dim),
                            wp2.reshape(-1), wo2.reshape(-1), **kv)
                    return pools, new_carry, outs, n_c, path

            spec_graph = _graphed(spec_body)

            def host_drafts(drafts, draft_len):
                return (torch.as_tensor(np.asarray(drafts, np.int32))
                        .reshape(-1, R - 1),
                        torch.as_tensor(np.asarray(draft_len, np.int32))
                        .reshape(-1))

            def spec_eager(pools, carry, page_table, drafts, draft_len):
                dev = carry["tokens"].device
                drafts, draft_len = host_drafts(drafts, draft_len)
                return spec_body(pools, carry, page_table, drafts.to(dev),
                                 draft_len.to(dev))

            def spec(pools, carry, page_table, drafts, draft_len):
                return spec_graph(pools, carry, page_table,
                                  *host_drafts(drafts, draft_len))

            spec.graph = spec_graph.graph

            # stamped like decode.eos_id / chunk.prefill_chunk: the batcher
            # drafts at ITS k and must reject a step built for another k,
            # freeze id or tree shape
            for fn in (spec, spec_eager):
                fn.eos_id = eos_id
                fn.speculate_k = K
                fn.spec_tree = tree
                fn.draft_source = draft_model

        # the batcher only sees the callables; stamp the freeze id so it
        # can reject a host truncation id the device disagrees with, and
        # the width with the bytes one step streams for its telemetry
        wbytes = model.weight_stream_bytes()
        for fn in (decode, decode_eager):
            fn.eos_id = eos_id
            fn.weight_dtype = wd_active
            fn.weight_stream_bytes = wbytes
        return GPTDecodeFns(
            prefill=prefill, decode=decode, decode_eager=decode_eager,
            spec_eager=spec_eager, eos_id=eos_id, chunk=chunk,
            prefill_chunk=getattr(chunk, "prefill_chunk", None), spec=spec,
            speculate_k=getattr(spec, "speculate_k", None),
            spec_tree=getattr(spec, "spec_tree", None),
            draft_source=getattr(spec, "draft_source", None),
            weight_dtype=wd_active, weight_stream_bytes=wbytes)

    def generate(
        self,
        prompts,
        prompt_lengths,
        max_new_tokens: int,
        *,
        page_size: int = 64,
        harvest_every: int = 8,
        max_seqs: Optional[int] = None,
        num_pages: Optional[int] = None,
        eos_id: Optional[int] = None,
        kv_dtype: Optional[Any] = None,
        kv_block: int = 128,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        key: Optional[Any] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        speculate_k: Optional[int] = None,
        draft_source: Optional[Any] = None,
        weight_dtype: Optional[str] = None,
        weight_block: int = 128,
    ):
        """Generate from ``prompts (b, s)`` (right-padded; real lengths in
        ``prompt_lengths``) through the serving stack: paged KV cache,
        decode kernel, on-device sampling, continuous batching.
        ``max_seqs`` (default ``b``) bounds concurrent slots.
        ``kv_dtype=torch.int8`` stores the cache quantized;
        ``weight_dtype="bf16"/"int8"/"int4"`` serves from a reduced-width
        weight pool (:meth:`decode_fns`).  ``prefill_chunk=C`` ingests
        prompts in C-token chunks under the stall-free scheduler, and
        ``prefix_cache=True`` shares identical prompt prefixes across
        requests (chunked only).  ``speculate_k=K`` turns on
        draft-and-verify speculative decoding, drafting from
        ``draft_source`` (default: n-gram self-speculation); a draft source
        built for a candidate tree (``ModelDraftSource(tree=...)``) makes
        the verify a tree verify of that shape; the tokens stay those of
        plain decoding.  ``temperature``/``top_k``/``top_p`` sample
        (:meth:`decode_fns`) and ``key`` (a host key of
        :mod:`apex_tpu_torch.random`, default ``PRNGKey(0)``) seeds the
        batcher, request ``i`` drawing under ``fold_in(key, i)``, as in
        JAX.  Returns the per-prompt generated token lists (EOS included
        when hit)."""
        c = self.config
        prompts = np.asarray(prompts)
        prompt_lengths = np.asarray(prompt_lengths)
        b, s = prompts.shape
        max_seqs = int(max_seqs or b)
        pages_per_seq = -(-(s + max_new_tokens) // page_size)
        ccfg = KVCacheConfig(
            num_layers=c.num_layers, num_heads=c.num_attention_heads,
            head_dim=c.head_dim,
            num_pages=int(num_pages or 1 + max_seqs * pages_per_seq),
            page_size=page_size, max_seqs=max_seqs,
            pages_per_seq=pages_per_seq, dtype=c.compute_dtype,
            kv_dtype=kv_dtype, kv_block=kv_block)
        fns = self.decode_fns(
            ccfg, max_prompt_len=s, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_id=eos_id, prefill_chunk=prefill_chunk,
            speculate_k=speculate_k,
            spec_tree=getattr(draft_source, "tree", None),
            weight_dtype=weight_dtype, weight_block=weight_block)
        batcher = ContinuousBatcher(
            fns.prefill, fns.decode, PagedKVCache(ccfg),
            init_pools(ccfg, self.device), max_prompt_len=s,
            harvest_every=harvest_every, eos_id=eos_id,
            chunk_fn=fns.chunk, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, spec_fn=fns.spec,
            speculate_k=speculate_k, draft_source=draft_source, key=key)
        reqs = [
            Request(uid=i,
                    prompt=[int(t) for t in
                            prompts[i, : int(prompt_lengths[i])]],
                    max_new_tokens=max_new_tokens)
            for i in range(b)
        ]
        comps = batcher.run(reqs)
        return [comps[i].tokens for i in range(b)]

    @torch.no_grad()
    def generate_reference(self, prompts, prompt_lengths,
                           max_new_tokens: int) -> np.ndarray:
        """Naive full-recompute GREEDY reference: every step re-runs the
        whole forward over the growing padded sequence and argmaxes the
        last valid position.  Exists to gate the paged path, never to
        serve.  A learned-position model needs ``s + max_new_tokens``
        within its table; a rope model runs any length.  Returns ``(b,
        new)``."""
        c = self.config
        prompts = np.asarray(prompts)
        b, s = prompts.shape
        total = s + max_new_tokens
        if c.position_embedding == "learned" and \
                total > c.max_position_embeddings:
            raise ValueError(
                f"reference needs {total} positions but the learned "
                f"table stops at {c.max_position_embeddings}")
        dev = self.device
        buf = torch.zeros((b, total), dtype=torch.int32, device=dev)
        buf[:, :s] = torch.as_tensor(prompts.astype(np.int32), device=dev)
        lens = torch.as_tensor(np.asarray(prompt_lengths, np.int64),
                               device=dev)
        rows = torch.arange(b, device=dev)
        outs = []
        for _ in range(max_new_tokens):
            logits = self.apply(buf)
            last = logits[rows, (lens - 1).clamp(0, total - 1)]
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
            buf[rows, lens] = nxt
            lens = lens + 1
            outs.append(nxt)
        return torch.stack(outs, dim=1).cpu().numpy()
